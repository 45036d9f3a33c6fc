"""Family dispatch (port of ``repro.models.registry``): one API over the
model families the port runs.

  init_params(cfg, seed=, device=)        -> params dict
  forward(params, cfg, batch)             -> (logits, aux)   [scoring / prefill]
  loss_fn(params, cfg, batch)             -> scalar
  cache_spec / init_cache                 -> decode state ((shape, dtype) / zeros)
  decode_step(params, cfg, cache, batch)  -> (logits, cache)

``ssm`` (rwkv6) and ``hybrid`` (hymba) are covered in full; ``dense``
has ``init_params``, ``forward`` and ``loss_fn`` (its decode here is the
contiguous-cache ``transformer.decode_step``, not ported yet; the serving
engine runs the paged one). Any other family raises
``NotImplementedError`` naming the slice that brings it. ``make_batch``
and ``input_specs`` are not ported yet.
"""
from __future__ import annotations

from repro_torch.models import hybrid, layers, ssm, transformer

_WHOLE = {"ssm": ssm, "hybrid": hybrid}
_LATER = {
    "moe": "the remaining-families slice (MoE dispatch)",
    "vlm": "the remaining-families slice (pixtral encoder)",
    "audio": "the remaining-families slice (whisper encoder, cross-attention)",
}


def _family_mod(cfg, fn: str):
    mod = _WHOLE.get(cfg.family)
    if mod is not None:
        return mod
    if cfg.family == "dense":
        if fn in ("init_params", "forward"):
            return transformer
        raise NotImplementedError(
            f"dense {fn} (contiguous-cache decode) is not ported yet: the "
            f"dense-decode slice brings it; the serving engine decodes the "
            f"dense family from paged pools"
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: "
        f"{_LATER.get(cfg.family, 'no slice plans it')} brings it"
    )


def init_params(cfg, *, seed: int = 0, device=None):
    return _family_mod(cfg, "init_params").init_params(cfg, seed=seed, device=device)


def forward(params, cfg, batch, **kw):
    return _family_mod(cfg, "forward").forward(params, cfg, batch, **kw)


def loss_fn(params, cfg, batch, **kw):
    if cfg.family == "dense":
        logits, aux = forward(params, cfg, batch, **kw)
        return layers.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size) + aux
    return _family_mod(cfg, "loss_fn").loss_fn(params, cfg, batch, **kw)


def cache_spec(cfg, batch: int, max_len: int):
    return _family_mod(cfg, "cache_spec").cache_spec(cfg, batch, max_len)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    return _family_mod(cfg, "init_cache").init_cache(cfg, batch, max_len, device=device)


def decode_step(params, cfg, cache, batch):
    return _family_mod(cfg, "decode_step").decode_step(params, cfg, cache, batch)
