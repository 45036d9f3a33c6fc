"""AdamW (port of ``repro.optim.adamw``).

The moments are fp32 (``cfg.optimizer_dtype``) and the update math is
fp32 whatever the parameters' dtype; each parameter is rounded back to its
own dtype. ``apply_updates`` works **in place**, one leaf at a time under
``torch.no_grad()``: the fp32 temporaries of the clip and the update
exist for one leaf at a time, and the parameter and moment tensors passed
in are the ones returned (the reference returns new trees). The
reference's moments inherit each parameter's sharding; on a mesh the
training loop (``runtime/train_loop.py``) applies the same per-leaf update
(``update_leaf``) to each rank's parts, with ``hyper`` and the global norm
computed once.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map

EPS = 1e-8


def init_state(params, dtype=torch.float32):
    """Zero moments ``m``, ``v`` shaped like ``params`` in ``dtype``, and
    the int32 step counter, on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by
    leaf in the tree's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def _clip_scale(norm, max_norm):
    # min(1, max_norm / max(norm, 1e-9)) as one fp32 division (a Python
    # scalar over a tensor would go through a reciprocal)
    return torch.clamp_max(torch.full_like(norm, max_norm) / norm.clamp_min(1e-9), 1.0)


def clip_by_global_norm(grads, max_norm):
    """(the fp32 gradients scaled to a global norm of at most ``max_norm``,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def lr_schedule(cfg, step):
    """Linear warm-up to ``cfg.learning_rate`` over ``cfg.warmup_steps``;
    ``step`` an int tensor, the result an fp32 tensor."""
    warm = torch.clamp_max(step.float() / max(cfg.warmup_steps, 1), 1.0)
    return cfg.learning_rate * warm


def hyper(cfg, norm, step):
    """The step's shared scalars from the gradients' global ``norm`` and
    the old step counter: (clip scale, new step, lr, bias corrections
    bc1, bc2), fp32 tensors but the int step."""
    step = step + 1
    return (_clip_scale(norm, cfg.grad_clip), step, lr_schedule(cfg, step),
            1.0 - torch.pow(cfg.beta1, step.float()), 1.0 - torch.pow(cfg.beta2, step.float()))


def update_leaf(cfg, p, g, m, v, scale, lr, bc1, bc2):
    """AdamW on one leaf, in place: the moments ``m``, ``v`` and the
    parameter ``p`` (rounded back to its dtype), from the gradient ``g``
    scaled by ``scale``."""
    b1, b2, wd = cfg.beta1, cfg.beta2, cfg.weight_decay
    gf = g.float() * scale
    m.mul_(b1).add_((1.0 - b1) * gf)
    v.mul_(b2).add_((1.0 - b2) * gf * gf)
    pf = p.float()
    delta = (m / bc1) / (torch.sqrt(v / bc2) + EPS) + wd * pf
    p.copy_(pf - lr * delta)


def apply_updates(cfg, params, grads, opt_state):
    """One AdamW step with global-norm clipping. Returns (params, opt_state,
    metrics {"grad_norm", "lr"}); ``params`` and the moments are updated in
    place and returned, the step counter is a new tensor."""
    with torch.no_grad():
        norm = global_norm(grads)
        scale, step, lr, bc1, bc2 = hyper(cfg, norm, opt_state["step"])
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                              leaves(opt_state["v"])):
            update_leaf(cfg, p, g, m, v, scale, lr, bc1, bc2)
    return (params, {"m": opt_state["m"], "v": opt_state["v"], "step": step},
            {"grad_norm": norm, "lr": lr})
