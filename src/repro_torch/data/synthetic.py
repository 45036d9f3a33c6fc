"""Deterministic synthetic training data (port of ``repro.data.synthetic``).

Every batch is a pure function of (seed, step): after a crash and restart
the stream resumes exactly where the checkpoint left it. Tokens follow a
Zipf law (numpy's ``zipf(1.3)``), clipped to the vocabulary.
``batch_at_step`` draws with the reference's numpy calls in the
reference's order, so one (seed, step) gives the reference's tokens and
labels (and the vlm's ``patches``, the audio family's ``frames``) bit for
bit.

``DataIterator`` prefetches on a host thread that builds numpy batches
(pinned host tensors for a CUDA device); the consumer moves each batch to
the device in ``__next__``, so no CUDA tensor is made on the side thread.
The reference's ``shardings`` (a mesh's placement) has no counterpart
yet: the port trains without a mesh. Nor has its ``cast``: the float
inputs stay fp32, and the models cast them to the activation dtype.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def batch_at_step(cfg, shape, seed: int, step: int,
                  batch_override: int | None = None,
                  seq_override: int | None = None) -> dict:
    """The (seed, step) batch as numpy arrays: ``tokens`` (B, S) and
    ``labels`` (B, S) int32, the tokens shifted by one. The vlm's text is
    S - num_patches tokens after its fp32 ``patches`` (B, num_patches, d),
    whose label positions are -1; the audio family adds fp32 ``frames``
    (B, encoder_seq, d). The float draws follow the tokens' Zipf draw."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"no synthetic batches for family {cfg.family!r}: one of {FAMILIES}"
        )
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    d = cfg.d_model
    raw = rng.zipf(1.3, size=(B, S + 1)) - 1
    toks = np.minimum(raw, cfg.vocab_size - 1).astype(np.int32)
    out, s_text = {}, S
    if cfg.family == "vlm":
        s_text = S - cfg.num_patches
        out["patches"] = rng.standard_normal((B, cfg.num_patches, d)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, cfg.encoder_seq, d)).astype(np.float32)
    out["tokens"] = toks[:, :s_text]
    labels = toks[:, 1: S + 1].copy()
    if cfg.family == "vlm":
        labels[:, : cfg.num_patches] = -1
    out["labels"] = labels
    return out


class DataIterator:
    """Yields ``(step, batch)`` from ``start_step`` on, the batch's tensors
    on ``device`` (default ``cuda``; raises without CUDA unless a device
    is given). Up to ``prefetch`` batches are built ahead on a host
    thread; ``close`` stops it."""

    def __init__(self, cfg, shape, seed=0, start_step=0, prefetch=2,
                 batch_override=None, seq_override=None, *, device=None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.batch_override = batch_override
        self.seq_override = seq_override
        self.device = resolve_device(device)
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step):
        b = batch_at_step(self.cfg, self.shape, self.seed, step,
                          self.batch_override, self.seq_override)
        host = {k: torch.from_numpy(v) for k, v in b.items()}
        if self.device.type == "cuda":  # page-locked host memory, not a CUDA tensor
            host = {k: v.pin_memory() for k, v in host.items()}
        return host

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            item = (step, self._make(step))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, host = self._q.get()
        return step, {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
