"""Train and serve steps and the fault-tolerant training loop
(port of ``repro.runtime.train_loop``).

A train step is the loss and its gradients (``torch.autograd.grad`` over
the parameter leaves; the blocks recompute under ``cfg.remat``, and the
attention and scan kernels carry their gradients through
``hopper/grads.py``), optionally accumulated over microbatches and
round-tripped through gradient compression, then AdamW, which updates the
state's tensors in place. ``run_training`` is the reference's loop
without a mesh: restore, the prefetching data stream, the step, the
straggler monitor, the failure injector and checkpoints, with the same
log lines. A mesh, and the reference's ``train_state_struct`` (the dry
run's shapes), wait for ROADMAP queue 1 items 2 and 3.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.tree import leaves, unflatten
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.optim import adamw, compression


def init_train_state(cfg, seed: int = 0, *, device=None):
    """{"params": the family's seeded ``init_params``, "opt": AdamW's
    zero state} on ``device`` (default ``cuda``)."""
    params = registry.init_params(cfg, seed=seed, device=device)
    return {"params": params,
            "opt": adamw.init_state(params, getattr(torch, cfg.optimizer_dtype))}


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


def make_train_step(cfg, microbatches: int | None = None, grad_compression: bool = False):
    """fwd + bwd + AdamW: ``train_step(state, batch) -> (state, metrics
    {"loss", "grad_norm", "lr"})``. ``microbatches > 1`` accumulates the
    gradients over batch tiles (``core.pipeline.microbatched``);
    ``grad_compression`` round-trips them through bf16 with fp32 error
    feedback (``state["grad_err"]``). The state's tensors are updated in
    place."""
    microbatches = microbatches if microbatches is not None else cfg.microbatches
    loss_and_grads = loss_and_grads_fn(cfg)
    if microbatches > 1:
        from repro_torch.core.pipeline import microbatched

        loss_and_grads = microbatched(loss_and_grads, microbatches)

    def train_step(state, batch):
        loss, grads = loss_and_grads(state["params"], batch)
        if grad_compression:
            grads, err = compression.compress_decompress(grads, state["grad_err"])
        params, opt, metrics = adamw.apply_updates(cfg, state["params"], grads, state["opt"])
        new_state = {"params": params, "opt": opt}
        if grad_compression:
            new_state["grad_err"] = err
        return new_state, {"loss": loss, **metrics}

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
    its tensors in place), ``device`` defaults to ``cuda``. An injected
    ``"crash"`` raises ``RuntimeError``."""
    from repro_torch.data.synthetic import DataIterator
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.fault_tolerance import StragglerMonitor

    if mesh is not None:
        raise NotImplementedError(
            "run_training(mesh=...): training on a mesh waits for the model-level "
            "sharding rules (ROADMAP queue 1 item 2)"
        )
    device = resolve_device(device)
    state = (initial_state if initial_state is not None
             else init_train_state(cfg, seed, device=device))
    if grad_compression and "grad_err" not in state:
        state["grad_err"] = compression.init_error_state(state["params"])
    start_step = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state = ckpt.restore(ckpt_dir, last, state)
            start_step = last
            log_fn(f"[restore] resumed from step {last}")

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
    return state, losses, monitor
