"""Train and serve steps and the fault-tolerant training loop
(port of ``repro.runtime.train_loop``).

A train step is the loss and its gradients (``torch.autograd.grad`` over
the parameter leaves; the blocks recompute under ``cfg.remat``, and the
attention and scan kernels carry their gradients through
``hopper/grads.py``), optionally accumulated over microbatches and
round-tripped through gradient compression, then AdamW, which updates the
state's tensors in place. ``run_training`` is the reference's loop:
restore, the prefetching data stream, the step, the straggler monitor,
the failure injector and checkpoints, with the same log lines.

On a mesh (``run_training(mesh=)``, a ``parallel.mesh.DeviceMesh`` with
``data`` and ``model`` axes) the state is placed as the reference's
``device_put(state, sspec)`` places it: ``param_specs(cfg, params, mesh,
"train")`` for the parameters, both moments and the compression residual,
``opt.step`` replicated; each rank holds its parts as separate
allocations (``sharding.Placed``). ``make_mesh_train_step`` gathers the
parameters, runs the same loss and autograd as the unsharded step under
``activation_sharding`` (so the MoE dispatch and the halo shift run per
rank), splits each gradient by its spec, clips by a global norm that
counts each element once, and applies AdamW per rank on its parts, on its
stream. The forward is not split per data rank: the MoE aux loss
``E * sum_e f_e p_e`` is not a mean over rows, so per-rank losses would not
average to the global batch's. ``train_state_struct`` is the state's
shapes and dtypes as ``meta`` tensors, with no storage (the dry run's).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.optim import adamw, compression
from repro_torch.parallel import sharding as sh


def init_train_state(cfg, seed: int = 0, *, device=None):
    """{"params": the family's seeded ``init_params``, "opt": AdamW's
    zero state} on ``device`` (default ``cuda``)."""
    params = registry.init_params(cfg, seed=seed, device=device)
    return {"params": params,
            "opt": adamw.init_state(params, getattr(torch, cfg.optimizer_dtype))}


def train_state_struct(cfg):
    """The train state's shapes and dtypes as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct`` tree): ``registry.param_shapes`` for
    the parameters, both moments in ``cfg.optimizer_dtype``, ``opt.step``
    an int32 scalar. Allocates nothing."""
    params = registry.param_shapes(cfg)
    opt_dt = getattr(torch, cfg.optimizer_dtype)

    def like(p):
        return torch.empty(p.shape, dtype=opt_dt, device="meta")

    return {"params": params,
            "opt": {"m": tree_map(like, params), "v": tree_map(like, params),
                    "step": torch.empty((), dtype=torch.int32, device="meta")}}


def state_from_jax(np_state, *, device=None):
    """The reference's train state (``params``, ``opt`` {m, v, step} and,
    with compression, ``grad_err``; numpy arrays or anything ``np.asarray``
    takes) as the port's, on ``device`` (default ``cuda``), through the
    families' ``params_from_jax``."""
    from repro_torch.models.transformer import params_from_jax

    device = resolve_device(device)
    state = {"params": params_from_jax(np_state["params"], device=device),
             "opt": {"m": params_from_jax(np_state["opt"]["m"], device=device),
                     "v": params_from_jax(np_state["opt"]["v"], device=device),
                     "step": torch.tensor(int(np.asarray(np_state["opt"]["step"])),
                                          dtype=torch.int32, device=device)}}
    if "grad_err" in np_state:
        state["grad_err"] = params_from_jax(np_state["grad_err"], device=device)
    return state


def loss_and_grads_fn(cfg):
    """``(params, batch) -> (loss, grads)``: the scalar loss (detached) and
    a gradient tree shaped like ``params``, each leaf in its parameter's
    dtype."""

    def loss_and_grads(params, batch):
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = registry.loss_fn(unflatten(params, ps), cfg, batch)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
        return loss.detach(), unflatten(params, gs)

    return loss_and_grads


def make_train_step(cfg, microbatches: int | None = None, grad_compression: bool = False,
                    grads_hook=None):
    """fwd + bwd + AdamW: ``train_step(state, batch) -> (state, metrics
    {"loss", "grad_norm", "lr"})``. ``microbatches > 1`` accumulates the
    gradients over batch tiles (``core.pipeline.microbatched``);
    ``grad_compression`` round-trips them through bf16 with fp32 error
    feedback (``state["grad_err"]``). ``grads_hook(grads)`` runs between
    the gradients and the update (the dry run's count settles each
    gradient's partial sums there). The state's tensors are updated in
    place."""
    microbatches = microbatches if microbatches is not None else cfg.microbatches
    loss_and_grads = loss_and_grads_fn(cfg)
    if microbatches > 1:
        from repro_torch.core.pipeline import microbatched

        loss_and_grads = microbatched(loss_and_grads, microbatches)

    def train_step(state, batch):
        loss, grads = loss_and_grads(state["params"], batch)
        if grads_hook is not None:
            grads_hook(grads)
        if grad_compression:
            grads, err = compression.compress_decompress(grads, state["grad_err"])
        params, opt, metrics = adamw.apply_updates(cfg, state["params"], grads, state["opt"])
        new_state = {"params": params, "opt": opt}
        if grad_compression:
            new_state["grad_err"] = err
        return new_state, {"loss": loss, **metrics}

    return train_step


def state_shardings(cfg, state, mesh):
    """The ``NamedSharding`` tree of a train state on ``mesh``: the
    parameters' ``param_specs`` (mode ``train``) for ``params``, ``opt.m``,
    ``opt.v`` and ``grad_err``; ``opt.step`` replicated."""
    pspecs = sh.param_specs(cfg, state["params"], mesh, "train")
    specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "step": sh.P()}}
    if "grad_err" in state:
        specs["grad_err"] = pspecs
    return sh.named(mesh, specs)


def mesh_grad_norm(mesh, grads) -> torch.Tensor:
    """The global norm of a list of ``Placed`` gradients, each element
    counted once: rank by rank, the fp32 sum of squares of the parts it
    owns (``Placed.owners``; a replicated part counts once), each on its
    stream, summed on the caller's stream in leaf and rank order."""
    total = None
    for g in grads:
        for r in g.owners:
            with mesh.on(r):
                part = torch.sum(torch.square(g.parts[r].float()))
            part = mesh.collect(part, r, g.parts[0].device)
            total = part if total is None else total + part
    return torch.sqrt(total)


def mesh_apply_updates(cfg, mesh, state, grads, norm):
    """AdamW on ``mesh``, in place: the shared scalars (``adamw.hyper``)
    from ``norm`` and the replicated step counter on the caller's stream,
    copied to each rank, then per rank, on its stream,
    ``adamw.update_leaf`` on every part it holds of the parameters, the
    moments and ``grads`` (``Placed``, in the parameters' order), and its
    copy of the counter advanced. Returns the step's learning rate."""
    ps, ms, vs = (leaves(state["params"]), leaves(state["opt"]["m"]),
                  leaves(state["opt"]["v"]))
    step = state["opt"]["step"]
    scale, _, lr, bc1, bc2 = adamw.hyper(cfg, norm, mesh.collect(step.parts[0], 0))
    for r in range(mesh.n):
        shared = [mesh.own(x, r) for x in (scale, lr, bc1, bc2)]
        with mesh.on(r):
            for p, g, m, v in zip(ps, grads, ms, vs):
                adamw.update_leaf(cfg, p.parts[r], g.parts[r], m.parts[r], v.parts[r], *shared)
            step.parts[r] += 1
    return lr


def make_mesh_train_step(cfg, mesh, microbatches: int | None = None,
                         grad_compression: bool = False):
    """``make_train_step`` on ``mesh``: ``train_step(state, batch) ->
    (state, metrics)`` over a state of ``sharding.Placed`` leaves
    (``state_shardings``), updated in place.

    1. gather the parameters (``Placed.gather``);
    2. the loss and its gradients, as the unsharded step computes them,
       under ``activation_sharding(default_activation_specs(cfg, mesh,
       "train"))``;
    3. each gradient split by its parameter's spec (the global gradient
       freed as its parts are made);
    4. with ``grad_compression``, the round trip per rank on its parts;
    5. the global norm over the owned parts (``mesh_grad_norm``);
    6. AdamW per rank on its parts, on its stream (``mesh_apply_updates``).
    """
    microbatches = microbatches if microbatches is not None else cfg.microbatches
    loss_and_grads = loss_and_grads_fn(cfg)
    if microbatches > 1:
        from repro_torch.core.pipeline import microbatched

        loss_and_grads = microbatched(loss_and_grads, microbatches)
    act = sh.default_activation_specs(cfg, mesh, "train")

    def train_step(state, batch):
        params = tree_map(lambda x: x.gather(), state["params"])
        with sh.activation_sharding(act):
            loss, grads = loss_and_grads(params, batch)
        del params
        gs = leaves(grads)
        del grads
        for i, p in enumerate(leaves(state["params"])):  # each global gradient goes
            gs[i] = sh.Placed.of(gs[i], p.sharding)      # as its parts come
        with torch.no_grad():
            if grad_compression:
                errs = leaves(state["grad_err"])
                for r in range(mesh.n):
                    with mesh.on(r):
                        cs, es = compression.compress_decompress(
                            [g.parts[r] for g in gs], [e.parts[r] for e in errs])
                    for g, e, c, ne in zip(gs, errs, cs, es):
                        g.parts[r], e.parts[r] = c, ne
            norm = mesh_grad_norm(mesh, gs)
            lr = mesh_apply_updates(cfg, mesh, state, gs, norm)
        return state, {"loss": loss, "grad_norm": norm, "lr": lr}

    return train_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = registry.forward(params, cfg, batch)
        return logits

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, batch):
        with torch.no_grad():
            return registry.decode_step(params, cfg, cache, batch)

    return decode_step


# ---------------------------------------------------------------------------
# fault-tolerant host loop
# ---------------------------------------------------------------------------


def run_training(
    cfg,
    shape,
    mesh=None,
    *,
    num_steps: int = 100,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    batch_override: int | None = None,
    seq_override: int | None = None,
    microbatches: int = 1,
    grad_compression: bool = False,
    failure_injector=None,
    log_every: int = 10,
    log_fn=print,
    device=None,
    initial_state=None,
):
    """The training loop: restore (the step count and the data stream
    both resume), prefetching data, the step, the straggler monitor,
    checkpoints every ``ckpt_every`` steps. Returns (state, losses,
    monitor). ``initial_state`` replaces the seeded initial state (the
    port's state tree, for example ``state_from_jax``'s; the loop updates
    its tensors in place), ``device`` defaults to the mesh's first device,
    else ``cuda``. An injected ``"crash"`` raises ``RuntimeError``.

    With ``mesh`` the state is placed on it (``state_shardings``; an
    ``initial_state`` dict is placed in place) and trained by
    ``make_mesh_train_step``; checkpoints hold the gathered leaves, and the
    state is returned gathered, in the unsharded tree form."""
    from repro_torch.data.synthetic import DataIterator
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.fault_tolerance import StragglerMonitor

    if device is None and mesh is not None:
        device = mesh.devices[0]
    device = resolve_device(device)
    last = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if initial_state is not None:
        state = initial_state
    else:  # a restore needs only the tree's shapes and dtypes to read into
        state = init_train_state(cfg, seed, device="meta" if last is not None else device)
    if grad_compression and "grad_err" not in state:
        state["grad_err"] = compression.init_error_state(state["params"])
    start_step = 0
    if last is not None:
        state = ckpt.restore(ckpt_dir, last, state, device=device)
        start_step = last
        log_fn(f"[restore] resumed from step {last}")

    if mesh is not None:
        sh.place_(state, state_shardings(cfg, state, mesh))
        step_fn = make_mesh_train_step(cfg, mesh, microbatches, grad_compression)
    else:
        step_fn = make_train_step(cfg, microbatches, grad_compression)
    data = DataIterator(cfg, shape, seed=seed, start_step=start_step,
                        batch_override=batch_override, seq_override=seq_override,
                        device=device)
    monitor = StragglerMonitor()
    losses = []
    try:
        for _ in range(num_steps - start_step):
            step, batch = next(data)
            if failure_injector is not None:
                kind = failure_injector.check(step)
                if kind == "crash":
                    raise RuntimeError(f"injected crash at step {step}")
                if kind == "straggle":
                    time.sleep(0.2)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            straggled = monitor.observe(dt)
            losses.append(loss)
            if step % log_every == 0:
                log_fn(
                    f"step {step:5d} loss {loss:8.4f} "
                    f"gnorm {float(metrics['grad_norm']):7.3f} "
                    f"{dt*1e3:7.1f} ms{' [straggle]' if straggled else ''}"
                )
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, step + 1, state)
                log_fn(f"[ckpt] step {step + 1}")
    finally:
        data.close()
    if mesh is not None:
        sh.gather_(state)
    return state, losses, monitor
