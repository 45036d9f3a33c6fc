"""Hymba-style hybrid blocks, the hybrid family (port of
``repro.models.hybrid``).

Each block feeds one normed input to BOTH a GQA attention path (sliding
window, a few global layers; ``ops.flash_attention``, the Hopper FA-2
kernel on the card) and a mamba/SSD path (data-dependent scalar decay per
head through the chunked scan ``ops.linear_attention``, the Hopper kernel
``csrc/linear_attention.cu``); the two normalized outputs are averaged.
The SSD inputs reach the scan as the reference builds them: C and B shared
by all heads and the decay shared by the state's N rows, here as stride-0
views that the kernel reads without a copy. Decode advances the state
through ``ops.linear_attention_step`` and attends against a contiguous KV
cache (``transformer.attention_decode``), as the reference does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.hopper import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import params_from_jax  # noqa: F401  (the family's API)
from repro_torch.parallel.sharding import constrain


def ssm_heads(cfg) -> int:
    return cfg.resolved_d_inner() // cfg.ssm_head_dim


def global_layer_mask(cfg) -> np.ndarray:
    """(L,) bool: which layers use full attention. ``num_global_layers``
    layers spread over the depth by rounding ``linspace(0, L - 1, n)`` half
    to even, as ``jnp.round`` does (32 layers, 3 global: 0, 16, 31)."""
    nl, ng = cfg.num_layers, cfg.num_global_layers
    mask = np.zeros((nl,), bool)
    if ng > 0:
        mask[np.round(np.linspace(0, nl - 1, ng, dtype=np.float32)).astype(np.int32)] = True
    return mask


def _check_family(cfg):
    if cfg.family != "hybrid":
        raise ValueError(f"models.hybrid runs the hybrid family, got {cfg.family!r}")


def init_params(cfg, *, seed: int = 0, device=None):
    """Random parameters with the reference's shapes, dtypes and scales,
    drawn on ``device`` (default ``cuda``; raises without CUDA unless a
    device is given) from a ``torch.Generator`` seeded with ``seed``."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.generator(device, seed)
    dtype = getattr(torch, cfg.dtype)
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    di, N = cfg.resolved_d_inner(), cfg.ssm_state
    nh = ssm_heads(cfg)
    vp = L.padded_vocab(cfg.vocab_size)

    def dense(shape, scale=None):
        return L.dense_init(gen, shape, scale=scale, dtype=dtype, device=device)

    def ones(*shape, dt=dtype):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(nl, d),
        "wq": dense((nl, d, H * hd)),
        "wk": dense((nl, d, K * hd)),
        "wv": dense((nl, d, K * hd)),
        "wo": dense((nl, H * hd, d), scale=1.0 / math.sqrt(H * hd)),
        "ssm_in": dense((nl, d, 2 * di)),
        "ssm_dt": dense((nl, d, nh)),
        "ssm_bc": dense((nl, d, 2 * N)),
        "ssm_out": dense((nl, di, d), scale=1.0 / math.sqrt(di)),
        "dt_bias": torch.zeros((nl, nh), dtype=torch.float32, device=device),
        "ssm_D": ones(nl, nh, dt=torch.float32),
        "attn_out_norm": ones(nl, d),
        "ssm_out_norm": ones(nl, d),
        "mlp_norm": ones(nl, d),
        "wi": dense((nl, d, f)),
        "wg": dense((nl, d, f)),
        "wo_mlp": dense((nl, f, d), scale=1.0 / math.sqrt(f)),
    }
    return {
        "embed": dense((vp, d), scale=0.02),
        "layers": layers,
        "final_norm": ones(d),
        "lm_head": dense((d, vp)),
    }


def _ssd_inputs(p, cfg, x):
    """x (B, S, d) -> (r, k, v, w_log) in (B, nh, S, ...) layout, plus
    (z, x_ssm). r = C and k = B are (B, S, N) broadcast over the heads and
    w_log = -dt (B, nh, S) broadcast over N: stride-0 views. dt's
    projection runs on fp32 copies of its bf16 operands, the reference's
    fp32-result einsum exactly."""
    B, S, _ = x.shape
    N = cfg.ssm_state
    hd, nh = cfg.ssm_head_dim, ssm_heads(cfg)
    x_ssm, z = torch.matmul(x, p["ssm_in"]).chunk(2, dim=-1)
    dt = F.softplus(torch.matmul(x.float(), p["ssm_dt"].float()) + p["dt_bias"])  # (B, S, nh)
    Bm, Cm = torch.matmul(x, p["ssm_bc"]).chunk(2, dim=-1)  # (B, S, N) each
    v = (x_ssm.reshape(B, S, nh, hd) * dt[..., None].to(x.dtype)).transpose(1, 2)
    r = Cm[:, None].expand(B, nh, S, N)
    k = Bm[:, None].expand(B, nh, S, N)
    w_log = (-dt).transpose(1, 2)[..., None].expand(B, nh, S, N)
    return r, k, v, w_log, z, x_ssm


def mamba_path(p, cfg, x, state=None):
    """x (B, S, d) -> (out (B, S, d), final SSD state (B, nh, N, hd) fp32)."""
    B, S, _ = x.shape
    di = cfg.resolved_d_inner()
    hd, nh = cfg.ssm_head_dim, ssm_heads(cfg)
    r, k, v, w_log, z, x_ssm = _ssd_inputs(p, cfg, x)
    o, S_out = ops.linear_attention(r, k, v, w_log, u=None, s0=state)
    o = o + p["ssm_D"][None, :, None, None].to(o.dtype) * (
        x_ssm.reshape(B, S, nh, hd).transpose(1, 2))
    y = o.transpose(1, 2).reshape(B, S, di)
    y = y * F.silu(z.float()).to(y.dtype)
    return torch.matmul(y, p["ssm_out"]), S_out


def _fuse(p, cfg, a, m):
    return 0.5 * (L.rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                  + L.rms_norm(m, p["ssm_out_norm"], cfg.norm_eps))


def block(p, cfg, h, cos, sin, is_global):
    n = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
    a = T.attention(p, cfg, n, cos, sin, window=0 if is_global else cfg.sliding_window)
    m, _ = mamba_path(p, cfg, n)
    h = h + _fuse(p, cfg, a, m)
    n = L.rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    return constrain(h + T._mlp(p, cfg, n), "residual")


def forward(params, cfg, batch, *, q_offset=0):
    """batch {"tokens": (B, S)} -> (logits (B, S, V_pad) in the activation
    dtype, aux loss 0.0). Under grad each block runs through
    ``transformer.remat_wrap``."""
    _check_family(cfg)
    h = constrain(params["embed"][batch["tokens"].long()], "residual")
    S = h.shape[1]
    cos, sin = L.rope_cos_sin(torch.arange(S, device=h.device) + q_offset,
                              cfg.resolved_head_dim(), cfg.rope_theta)
    blk = T.remat_wrap(cfg, block)
    for p, is_global in zip(T.layer_views(params), global_layer_mask(cfg)):
        h = blk(p, cfg, h, cos, sin, bool(is_global))
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return constrain(torch.matmul(h, params["lm_head"]), "logits"), 0.0


def loss_fn(params, cfg, batch, *, q_offset=0):
    logits, aux = forward(params, cfg, batch, q_offset=q_offset)
    return L.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int):
    """name -> (shape, dtype): the contiguous KV cache and the SSD state."""
    hd, K, nl = cfg.resolved_head_dim(), cfg.num_kv_heads, cfg.num_layers
    nh, N, sd = ssm_heads(cfg), cfg.ssm_state, cfg.ssm_head_dim
    dt = getattr(torch, cfg.dtype)
    return {
        "k": ((nl, batch, K, max_len, hd), dt),
        "v": ((nl, batch, K, max_len, hd), dt),
        "ssm_state": ((nl, batch, nh, N, sd), torch.float32),
    }


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zeros of ``cache_spec`` on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in cache_spec(cfg, batch, max_len).items()}


def decode_step(params, cfg, cache, batch):
    """batch {"token": (B,), "position": (B,)} -> (logits (B, V_pad) fp32,
    cache). The cache's tensors are updated in place and returned."""
    _check_family(cfg)
    position = batch["position"]
    sd, nh = cfg.ssm_head_dim, ssm_heads(cfg)
    h = params["embed"][batch["token"].long()]
    cos, sin = L.rope_cos_sin(position, cfg.resolved_head_dim(), cfg.rope_theta)
    for i, is_global in enumerate(global_layer_mask(cfg)):
        lp = T._layer(params, i)
        n = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a, _, _ = T.attention_decode(
            lp, cfg, n, cos, sin, cache["k"][i], cache["v"][i], position,
            window=0 if is_global else cfg.sliding_window,
        )
        r, k, v, w_log, z, x_ssm = _ssd_inputs(lp, cfg, n[:, None, :])
        o, S = ops.linear_attention_step(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], w_log[:, :, 0], None, cache["ssm_state"][i])
        cache["ssm_state"][i].copy_(S)
        o = o + lp["ssm_D"][None, :, None].to(o.dtype) * x_ssm.reshape(-1, nh, sd)
        y = o.reshape(-1, nh * sd) * F.silu(z[:, 0].float()).to(o.dtype)
        m = torch.matmul(y, lp["ssm_out"]).to(h.dtype)
        h = h + _fuse(lp, cfg, a, m)
        n = L.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + T._mlp(lp, cfg, n[:, None, :])[:, 0]
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return torch.matmul(h.float(), params["lm_head"].float()), cache
