"""Family dispatch (port of ``repro.models.registry``): one API over the
model families the port runs.

  init_params(cfg, seed=, device=)        -> params dict
  forward(params, cfg, batch)             -> (logits, aux)   [scoring / prefill]
  loss_fn(params, cfg, batch)             -> scalar
  cache_spec / init_cache                 -> decode state ((shape, dtype) / zeros)
  decode_step(params, cfg, cache, batch)  -> (logits, cache)
  make_batch(cfg, shape, rng, ...)        -> concrete synthetic batch

``dense`` (the transformer, its decode from the contiguous cache), ``ssm``
(rwkv6) and ``hybrid`` (hymba) are covered in full; every decode updates
its cache in place. Any other family raises ``NotImplementedError`` naming
the slice that brings it. ``input_specs`` (the dry run's stand-ins) is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import hybrid, layers, ssm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm, "hybrid": hybrid}
_LATER = {
    "moe": "the remaining-families slice (MoE dispatch)",
    "vlm": "the remaining-families slice (pixtral encoder)",
    "audio": "the remaining-families slice (whisper encoder, cross-attention)",
}


def _family_mod(cfg):
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_LATER.get(cfg.family, 'no slice plans it')} brings it"
        )
    return mod


def init_params(cfg, *, seed: int = 0, device=None):
    return _family_mod(cfg).init_params(cfg, seed=seed, device=device)


def forward(params, cfg, batch, **kw):
    return _family_mod(cfg).forward(params, cfg, batch, **kw)


def loss_fn(params, cfg, batch, **kw):
    if cfg.family == "dense":
        logits, aux = forward(params, cfg, batch, **kw)
        return layers.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size) + aux
    return _family_mod(cfg).loss_fn(params, cfg, batch, **kw)


def cache_spec(cfg, batch: int, max_len: int):
    return _family_mod(cfg).cache_spec(cfg, batch, max_len)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    return _family_mod(cfg).init_cache(cfg, batch, max_len, device=device)


def decode_step(params, cfg, cache, batch):
    return _family_mod(cfg).decode_step(params, cfg, cache, batch)


def make_batch(cfg, shape, rng=None, batch_override: int | None = None,
               seq_override: int | None = None, *, device=None):
    """Concrete synthetic batch for ``shape`` (a ``configs.base.ShapeSpec``):
    int32 tensors on ``device`` (default ``cuda``). The integers come from
    the numpy ``Generator`` ``rng`` (default seed 0) in the reference's
    order, so one seed gives the reference's batch: train/prefill draw
    ``tokens`` (B, S), then train ``labels`` (B, S); decode draws ``token``
    (B,), then ``position`` (B,) in [S // 2, S - 1)."""
    _family_mod(cfg)
    device = resolve_device(device)
    rng = rng if rng is not None else np.random.default_rng(0)
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len

    def tensor(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(device)

    if shape.kind in ("train", "prefill"):
        out = {"tokens": tensor(rng.integers(0, cfg.vocab_size, (B, S)))}
        if shape.kind == "train":
            out["labels"] = tensor(rng.integers(0, cfg.vocab_size, (B, S)))
        return out
    return {"token": tensor(rng.integers(0, cfg.vocab_size, (B,))),
            "position": tensor(rng.integers(S // 2, S - 1, (B,)))}
