"""Decoder-only transformer LM: the dense, MoE and vlm families (port of
``repro.models.transformer``).

Parameters are a plain dict of tensors with the reference's layout: the
per-layer leaves stacked on a leading ``num_layers`` axis (layer ``i`` is
the view ``leaf[i]``). Covers GQA/MQA, qk-norm, QKV biases, gated/plain
MLPs, the GPT-J parallel-residual block, MoE layers (``models/moe.py``:
``moe_mlp`` in forward and prefill, ``moe_mlp_decode`` in both decodes;
each block's aux loss is summed into ``forward``'s second return value)
and the vlm's patch embeddings, put through the connector and prepended to
the tokens (``embed_inputs``). ``attention`` also serves the audio family's
encoder and cross-attention (``kv_input``). Prefill attention goes through
``ops.flash_attention`` (the Hopper FA-2 kernel on the card); decode, from
the contiguous cache (``decode_step``, which the hybrid and audio families'
decodes share through ``attention_decode``) or from paged pools
(``decode_step_paged``), through ``ops.decode_attention``. Both decodes
write the new token's k/v into the cache in place, where the reference's
scan returns new caches. Projections are ``torch.matmul``, as the
reference leaves them to XLA einsums. Prefill logits are cast to the
activation dtype; decode logits stay fp32, as in the reference.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import tracing
from repro_torch.core import precision as prec
from repro_torch.device import resolve_device
from repro_torch.hopper import ops
from repro_torch.hopper.blocked import as_bytes
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel.sharding import constrain

FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the transformer serves the families {FAMILIES}, got {cfg.family!r}"
        )


# ---------------------------------------------------------------------------
# init / weight carry-over
# ---------------------------------------------------------------------------


def init_params(cfg, *, seed: int = 0, device=None):
    """Random parameters with the reference's shapes and scales, drawn on
    ``device`` (default ``cuda``; raises without CUDA unless a device is
    given) from a ``torch.Generator`` seeded with ``seed``. The draws differ
    from ``jax.random``'s; tests carry JAX weights over with
    ``params_from_jax``."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.generator(device, seed)
    dtype = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim()
    H, K, nl = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    vp = L.padded_vocab(cfg.vocab_size)

    def dense(shape, scale=None, dtype=dtype):
        return L.dense_init(gen, shape, scale=scale, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones(nl, d),
        "wq": dense((nl, d, H * hd)),
        "wk": dense((nl, d, K * hd)),
        "wv": dense((nl, d, K * hd)),
        "wo": dense((nl, H * hd, d), scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        layers.update(bq=zeros(nl, H * hd), bk=zeros(nl, K * hd),
                      bv=zeros(nl, K * hd))
    if cfg.qk_norm:
        layers.update(q_norm=ones(nl, hd), k_norm=ones(nl, hd))
    if not cfg.parallel_block:
        layers["mlp_norm"] = ones(nl, d)
    if cfg.num_experts:
        layers.update(M.init_moe_params(dense, cfg, nl, dtype))
    else:
        layers["wi"] = dense((nl, d, f))
        if L.is_gated(cfg.activation):
            layers["wg"] = dense((nl, d, f))
        layers["wo_mlp"] = dense((nl, f, d), scale=1.0 / math.sqrt(f))
    params = {
        "embed": dense((vp, d), scale=0.02),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, vp))
    if cfg.family == "vlm":
        params["connector"] = {"wi": dense((d, d)), "wo": dense((d, d))}
    return params


def _to_torch(x, device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: carry the raw bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_params, *, device=None):
    """Carry a reference parameter tree (any family's ``init_params``, as
    numpy arrays or anything ``np.asarray`` takes; nested dicts such as the
    vlm's ``connector`` or the audio family's ``enc_layers`` stay nested)
    over to the port's dict of tensors on ``device`` (default ``cuda``)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_torch(node, device)

    return conv(np_params)


def _head(params):
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def _layer(params, i):
    return {k: v[i] for k, v in params["layers"].items()}


def layer_views(params):
    """Per-layer dicts of views of the stacked leaves, one ``unbind`` a
    leaf: under autograd each leaf's gradient is stacked once from the
    layers' (indexing layer by layer would add a zero-padded gradient of
    the whole leaf for every layer). The values are ``_layer``'s."""
    names = list(params["layers"])
    columns = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, vals)) for vals in zip(*columns)]


# "dots": the outputs of the projections (products with no batch dims,
# which reach aten as mm/addmm) are saved, everything else is recomputed:
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(cfg, fn):
    """``fn`` (one block) under ``cfg.remat`` while grad is enabled:
    ``"full"`` recomputes the block in the backward
    (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` saves the
    projections' outputs and recomputes the rest, ``"none"`` is the plain
    call. With grad disabled (inference) it is always the plain call.
    ``gather_save_policy`` saves the cross-device gathers in the
    reference; one device gathers nothing, so it recomputes everything,
    as ``"full"`` does."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots" and not cfg.gather_save_policy:
        kw["context_fn"] = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)
    elif cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}; one of full, dots, none")

    def wrapped(*args, **kwargs):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)

    return wrapped


def _rope(cfg, positions):
    if not cfg.rope_theta:
        return None, None
    return L.rope_cos_sin(positions, cfg.resolved_head_dim(), cfg.rope_theta)


def _mlp(p, cfg, x):
    q = {"wi": p["wi"], "wo": p["wo_mlp"]}
    if "wg" in p:
        q["wg"] = p["wg"]
    return L.mlp(q, x, cfg.activation)


def _ffn(p, cfg, x):
    """The block's feed-forward: (out, aux loss), MoE where the config has
    experts."""
    if cfg.num_experts:
        return M.moe_mlp(p, x, cfg)
    return _mlp(p, cfg, x), 0.0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention(p, cfg, x, cos, sin, *, causal=True, window=0, q_offset=0,
              kv_input=None, kv_cos_sin=None, return_kv=False, scale=None):
    """x (B, S, d) -> (B, S, d); with ``return_kv`` also the (B, K, Skv, hd)
    k/v this layer caches. ``kv_input`` (B, Skv, d) makes it
    cross-attention: k/v come from it, with its own length. Rope (where
    ``cos`` is given) turns q and, in self-attention, k; in
    cross-attention k turns only by ``kv_cos_sin``, where given. ``scale``
    multiplies the scores (default 1 / sqrt(head_dim))."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    xkv = x if kv_input is None else kv_input
    Skv = xkv.shape[1]
    q = torch.matmul(x, p["wq"])
    k, v = torch.matmul(xkv, p["wk"]), torch.matmul(xkv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, Skv, K, hd)
    v = v.reshape(B, Skv, K, hd)
    if "q_norm" in p:
        q = L.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cos is not None:
        q = L.apply_rope(q, cos, sin)
        if kv_input is None:
            k = L.apply_rope(k, cos, sin)
        elif kv_cos_sin is not None:
            k = L.apply_rope(k, *kv_cos_sin)
    q = constrain(q, "attn_q")
    k = constrain(k, "attn_kv")
    v = constrain(v, "attn_kv")
    # (B, S, H, hd) -> (B, H, S, hd) views: the kernel takes the strides
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                            q_offset=q_offset, scale=scale)
    out = torch.matmul(o.transpose(1, 2).reshape(B, S, H * hd), p["wo"])
    if return_kv:
        return out, (kt, vt)
    return out


def _block(p, cfg, h, cos, sin, *, q_offset=0, return_kv=False):
    """One block: -> (h, the layer's k/v or None, the block's aux loss)."""
    n = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
    a = attention(p, cfg, n, cos, sin, window=cfg.sliding_window,
                  q_offset=q_offset, return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    if cfg.parallel_block:
        m, aux = _ffn(p, cfg, n)
        h = h + a + m
    else:
        h = h + a
        m, aux = _ffn(p, cfg, L.rms_norm(h, p["mlp_norm"], cfg.norm_eps))
        h = h + m
    return constrain(h, "residual"), kv, aux


def _logits(params, cfg, h):
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return torch.matmul(h, _head(params))


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, batch):
    """Token embeddings (B, S, d); for the vlm, the patch embeddings
    ``batch["patches"]`` (B, P, d) from the stubbed vision tower, put
    through the connector ``gelu_tanh(patches @ wi) @ wo`` and prepended:
    (B, P + S, d)."""
    h = params["embed"][batch["tokens"].long()]
    if cfg.family == "vlm":
        c = params["connector"]
        patches = batch["patches"].to(h.dtype)
        pe = torch.matmul(L.activation_fn("gelu")(torch.matmul(patches, c["wi"])), c["wo"])
        h = torch.cat([pe.to(h.dtype), h], dim=1)
    return constrain(h, "residual")


def forward(params, cfg, batch, *, q_offset=0):
    """batch {"tokens": (B, S)} (+ ``patches`` for the vlm) -> (logits
    (B, S_total, V_pad), aux loss: 0.0 for the dense family, the sum of the
    blocks' MoE aux losses for the MoE one). Under grad each block runs
    through ``remat_wrap``."""
    _check_family(cfg)
    h = embed_inputs(params, cfg, batch)
    S = h.shape[1]
    cos, sin = _rope(cfg, torch.arange(S, device=h.device) + q_offset)
    blk = remat_wrap(cfg, functools.partial(_block, cfg=cfg, q_offset=q_offset))
    aux = 0.0
    for p in layer_views(params):
        h, _, a = blk(p, h=h, cos=cos, sin=sin)
        aux = aux + a
    return constrain(_logits(params, cfg, h), "logits"), aux


def prefill_step(params, cfg, batch, max_len: int):
    """Process full prompts (+ ``patches`` for the vlm, prepended): ->
    (logits (B, S_total, V_pad) in the activation dtype, cache {"k", "v"}:
    (nl, B, K, max_len, hd), zero past S_total). The MoE aux loss is
    dropped, as in the reference."""
    _check_family(cfg)
    h = embed_inputs(params, cfg, batch)
    S = h.shape[1]
    cos, sin = _rope(cfg, torch.arange(S, device=h.device))
    ks, vs = [], []
    for i in range(cfg.num_layers):
        h, (k, v), _ = _block(_layer(params, i), cfg, h, cos, sin, return_kv=True)
        ks.append(k)
        vs.append(v)
    pad = max_len - S
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if pad > 0:
        k_all = torch.nn.functional.pad(k_all, (0, 0, 0, pad))
        v_all = torch.nn.functional.pad(v_all, (0, 0, 0, pad))
    return _logits(params, cfg, h), {"k": k_all, "v": v_all}


# ---------------------------------------------------------------------------
# contiguous-cache decode
# ---------------------------------------------------------------------------


def attention_decode(p, cfg, x, cos, sin, k_cache, v_cache, position, *, window=0):
    """One layer's decode against a contiguous cache: x (B, d); caches
    (B, K, Smax, hd); position (B,) absolute index. The new token's k/v is
    written **in place** at ``position``, then attention runs through the
    contiguous ``ops.decode_attention``. Returns (o (B, d), k_cache, v_cache)."""
    B, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, H, hd)
    k = k.reshape(B, K, hd)
    v = v.reshape(B, K, hd)
    if "q_norm" in p:
        q = L.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cos is not None:  # cos/sin (B, hd / 2) from per-row positions
        q = L.apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = L.apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    rows, pos = torch.arange(B, device=x.device), position.long()
    k_cache[rows, :, pos] = k.to(k_cache.dtype)
    v_cache[rows, :, pos] = v.to(v_cache.dtype)
    o = ops.decode_attention(q, k_cache, v_cache, position, window=window)
    return torch.matmul(o.reshape(B, H * hd), p["wo"]), k_cache, v_cache


def cache_spec(cfg, batch: int, max_len: int):
    """name -> (shape, dtype): k and v, each (nl, B, K, max_len, hd) in the
    config's dtype."""
    hd, K, nl = cfg.resolved_head_dim(), cfg.num_kv_heads, cfg.num_layers
    kv = ((nl, batch, K, max_len, hd), getattr(torch, cfg.dtype))
    return {"k": kv, "v": kv}


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zeros of ``cache_spec`` on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in cache_spec(cfg, batch, max_len).items()}


def _ffn_decode(p, cfg, x):
    if cfg.num_experts:
        return M.moe_mlp_decode(p, x, cfg)
    return _mlp(p, cfg, x)


def decode_step(params, cfg, cache, batch):
    """batch {"token": (B,), "position": (B,)} -> (logits (B, V_pad) fp32,
    cache). Walks the layers over the views ``cache["k"][i]``,
    ``cache["v"][i]``: each layer's new k/v row is written **in place** at
    ``position`` (the reference's scan returns new caches instead), and the
    cache passed in is returned. A caller that needs the cache as it was
    clones it first."""
    _check_family(cfg)
    position = batch["position"]
    h = params["embed"][batch["token"].long()]
    cos, sin = _rope(cfg, position)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        n = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        a, _, _ = attention_decode(p, cfg, n, cos, sin, cache["k"][i], cache["v"][i],
                                   position, window=cfg.sliding_window)
        if cfg.parallel_block:
            h = h + a + _ffn_decode(p, cfg, n)
        else:
            h = h + a
            h = h + _ffn_decode(p, cfg, L.rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    # fp32 logits, as the reference's einsum with an fp32 result
    return torch.matmul(h.float(), _head(params).float()), cache


# ---------------------------------------------------------------------------
# paged decode (serving engine: block-table KV cache)
# ---------------------------------------------------------------------------


def attention_decode_paged(p, cfg, x, cos, sin, k_pool, v_pool, block_table,
                           position, *, window=0, k_scale=None, v_scale=None,
                           policy=None, attn_fn=None, scale=None):
    """One layer's decode against paged pools ``k_pool``/``v_pool``
    (P, K, bs, hd). The new token's k/v is written **in place** into page
    ``block_table[b, pos // bs]`` at row ``pos % bs``, then attention runs
    through the paged ``ops.decode_attention``, or through ``attn_fn(q,
    k_pool, v_pool, k_scale, v_scale, block_table, position, window)`` where
    the serving layer injects a distribution (the engine's ring decode).
    Inactive slots point at the shared scratch page, which live prefixes
    never reference.

    Under ``policy`` the pools hold the cache narrow: the new k/v row is
    quantized per row (``precision.quantize_kv_cache``) and written with
    its scales into ``k_scale``/``v_scale`` (P, K, bs, 1), and the pools'
    scales go to ``ops.decode_attention``, which dequantizes at use.
    ``scale`` multiplies the scores (default 1 / sqrt(head_dim)); an
    ``attn_fn`` takes the default only."""
    if scale is not None and attn_fn is not None:
        raise ValueError("attention_decode_paged: an attn_fn takes the default scale only")
    B, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    bs = k_pool.shape[2]
    q, k, v = (torch.matmul(x, p[w]) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, H, hd)
    k = k.reshape(B, K, hd)
    v = v.reshape(B, K, hd)
    if "q_norm" in p:
        q = L.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cos is not None:
        q = L.apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = L.apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]

    phys = torch.gather(block_table, 1, (position // bs).long()[:, None])[:, 0].long()
    offset = (position % bs).long()
    heads = torch.arange(K, device=x.device)[None, :]
    rows = {"k": (k_pool, k), "v": (v_pool, v)}
    if policy is not None:
        kq, ks, vq, vs = prec.quantize_kv_cache(k, v, policy)
        rows = {"k": (k_pool, kq), "v": (v_pool, vq),
                "k_scale": (k_scale, ks), "v_scale": (v_scale, vs)}
    for pool, row in rows.values():
        as_bytes(pool)[phys[:, None], heads, offset[:, None]] = as_bytes(row.to(pool.dtype))

    with tracing.span("decode.pages"):
        if attn_fn is None:
            o = ops.decode_attention(q, k_pool, v_pool, position, paged=True,
                                     block_table=block_table, window=window, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)
        else:
            o = attn_fn(q, k_pool, v_pool, k_scale, v_scale, block_table, position, window)
    return torch.matmul(o.reshape(B, H * hd), p["wo"])


def decode_step_paged(params, cfg, cache, batch, *, attn_fn=None):
    """batch {"token": (B,), "position": (B,), "block_table": (B, NB)};
    ``cache`` a ``serving.paged_cache.PagedKVCache`` (only its pools, their
    scales and its policy are touched, and the pools are updated in place);
    ``attn_fn`` replaces each layer's paged ``decode_attention``
    (``attention_decode_paged``). Returns (logits (B, V_pad) fp32, cache)."""
    _check_family(cfg)
    position, block_table = batch["position"], batch["block_table"]
    h = params["embed"][batch["token"].long()]
    cos, sin = _rope(cfg, position)
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        n = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        scales = ({} if cache.k_scale is None else
                  dict(k_scale=cache.k_scale[i], v_scale=cache.v_scale[i]))
        a = attention_decode_paged(
            p, cfg, n, cos, sin, cache.k_pool[i], cache.v_pool[i],
            block_table, position, window=cfg.sliding_window,
            policy=cache.policy, attn_fn=attn_fn, **scales,
        )
        if cfg.parallel_block:
            h = h + a + _ffn_decode(p, cfg, n)
        else:
            h = h + a
            h = h + _ffn_decode(p, cfg, L.rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    # fp32 logits, as the reference's einsum with an fp32 result
    return torch.matmul(h.float(), _head(params).float()), cache


# the paged engine's interface (``serving/engine.py`` ``PagedModel``), which
# ``models/granite_hybrid.py`` shares


def paged_layout(cfg, slots: int, *, device=None):
    """(the window of each layer that keeps KV, the per-slot state pool):
    every layer keeps KV, and none a state."""
    return (cfg.sliding_window or 0,) * cfg.num_layers, {}


def paged_prefill(params, cfg, tokens, length: int):
    """One prompt padded to its bucket, tokens (1, S) of which ``length``
    are real: -> (logits (V_pad,) at the last real token, {"k", "v"}:
    (nl, 1, K, S, hd), the slot's state: none)."""
    logits, kv = prefill_step(params, cfg, {"tokens": tokens}, max_len=tokens.shape[1])
    return logits[0, length - 1], kv, {}


def paged_decode(params, cfg, cache, batch, state, attn_fn=None):
    """``decode_step_paged``; ``state`` is the empty pool."""
    return decode_step_paged(params, cfg, cache, batch, attn_fn=attn_fn)
