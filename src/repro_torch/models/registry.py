"""Family dispatch (port of ``repro.models.registry``): one API over the
model families the port runs.

  init_params(cfg, seed=, device=)        -> params dict
  param_shapes(cfg)                       -> the same dict on the meta device
  forward(params, cfg, batch)             -> (logits, aux)   [scoring / prefill]
  loss_fn(params, cfg, batch)             -> scalar
  cache_spec / init_cache                 -> decode state ((shape, dtype) / zeros)
  decode_step(params, cfg, cache, batch)  -> (logits, cache)
  make_batch(cfg, shape, rng, ...)        -> concrete synthetic batch
  input_specs(cfg, shape)                 -> name -> (shape, dtype) stand-ins

Every family of the reference is covered: ``dense``, ``moe`` and ``vlm``
(the transformer), ``ssm`` (rwkv6), ``hybrid`` (hymba) and ``audio``
(whisper, ``models/multimodal.py``); every decode updates its cache in
place. The port's own ``granite_hybrid`` family (Granite-4.0-H, which the
reference lacks) has init and forward here and decodes through the paged
engine only (``serving/engine.py``). A family the port does not know raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import granite_hybrid, hybrid, layers, multimodal, ssm, transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": ssm, "hybrid": hybrid, "audio": multimodal,
             "granite_hybrid": granite_hybrid}


def _family_mod(cfg):
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not one the port knows: {sorted(_FAMILIES)}"
        )
    return mod


def init_params(cfg, *, seed: int = 0, device=None):
    return _family_mod(cfg).init_params(cfg, seed=seed, device=device)


def param_shapes(cfg):
    """The parameter tree of ``init_params`` with no storage: ``meta``
    tensors carrying each leaf's shape and dtype (the reference's
    ``jax.eval_shape``), so a full-width config costs no memory."""
    return init_params(cfg, seed=0, device="meta")


def forward(params, cfg, batch, **kw):
    return _family_mod(cfg).forward(params, cfg, batch, **kw)


def loss_fn(params, cfg, batch, **kw):
    """Cross-entropy over labels >= 0, plus the forward's aux loss (the
    MoE load-balance term; 0.0 elsewhere)."""
    if _family_mod(cfg) is transformer:
        logits, aux = forward(params, cfg, batch, **kw)
        return layers.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size) + aux
    return _family_mod(cfg).loss_fn(params, cfg, batch, **kw)


def cache_spec(cfg, batch: int, max_len: int):
    return _family_mod(cfg).cache_spec(cfg, batch, max_len)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    return _family_mod(cfg).init_cache(cfg, batch, max_len, device=device)


def decode_step(params, cfg, cache, batch):
    return _family_mod(cfg).decode_step(params, cfg, cache, batch)


def input_specs(cfg, shape):
    """name -> (shape, dtype) of the batch for ``shape`` (a
    ``configs.base.ShapeSpec``), the reference's stand-ins: train/prefill
    carry the vlm's ``patches`` (B, num_patches, d) or the audio family's
    ``frames`` (B, encoder_seq, d) in the config's dtype, then ``tokens``
    (the vlm's text is S - num_patches long) and, to train, ``labels``
    (B, S); decode carries ``token`` and ``position`` (B,)."""
    B, S = shape.global_batch, shape.seq_len
    i32, emb, d = torch.int32, getattr(torch, cfg.dtype), cfg.d_model
    if shape.kind not in ("train", "prefill"):
        return {"token": ((B,), i32), "position": ((B,), i32)}
    specs, s_text = {}, S
    if cfg.family == "vlm":
        s_text = S - cfg.num_patches
        specs["patches"] = ((B, cfg.num_patches, d), emb)
    if cfg.family == "audio":
        specs["frames"] = ((B, cfg.encoder_seq, d), emb)
    specs["tokens"] = ((B, s_text), i32)
    if shape.kind == "train":
        specs["labels"] = ((B, S), i32)
    return specs


def make_batch(cfg, shape, rng=None, batch_override: int | None = None,
               seq_override: int | None = None, *, device=None):
    """Concrete synthetic batch for ``shape`` (a ``configs.base.ShapeSpec``)
    on ``device`` (default ``cuda``), drawn from the numpy ``Generator``
    ``rng`` (default seed 0) in the reference's order, so one seed gives
    the reference's batch: train/prefill draw the vlm's ``patches`` or the
    audio family's ``frames`` (standard normal, in the config's dtype)
    first, then ``tokens`` (int32; the vlm's text is S - num_patches
    long), then train ``labels`` (B, S; -1 on the vlm's patch positions);
    decode draws ``token`` (B,), then ``position`` (B,) in
    [S // 2, S - 1)."""
    _family_mod(cfg)
    device = resolve_device(device)
    rng = rng if rng is not None else np.random.default_rng(0)
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    d = cfg.d_model

    def tensor(x, dtype=torch.int32):
        # float draws go through fp32 first, as jnp.asarray's do
        x = np.asarray(x, np.int32 if dtype == torch.int32 else np.float32)
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    if shape.kind not in ("train", "prefill"):
        return {"token": tensor(rng.integers(0, cfg.vocab_size, (B,))),
                "position": tensor(rng.integers(S // 2, S - 1, (B,)))}
    out, s_text, emb = {}, S, getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        s_text = S - cfg.num_patches
        out["patches"] = tensor(rng.standard_normal((B, cfg.num_patches, d)), emb)
    if cfg.family == "audio":
        out["frames"] = tensor(rng.standard_normal((B, cfg.encoder_seq, d)), emb)
    out["tokens"] = tensor(rng.integers(0, cfg.vocab_size, (B, s_text)))
    if shape.kind == "train":
        labels = rng.integers(0, cfg.vocab_size, (B, S))
        if cfg.family == "vlm":
            labels[:, : cfg.num_patches] = -1  # no loss on the image positions
        out["labels"] = tensor(labels)
    return out
