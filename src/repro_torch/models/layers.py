"""Shared building blocks of the port's models (plain functions on tensors).

Numerics follow ``repro.models.layers``: RMSNorm (not LayerNorm) in fp32,
cast back; half-split rotary embedding in fp32; ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default); the vocabulary is padded to a
multiple of 128. Projections run as ``torch.matmul`` in the activation
dtype (fp32 accumulation inside the GEMM, one rounding at the end); the
reference keeps their fp32 result until the same cast, which is the same
thing in the fp32 configs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VOCAB_PAD_MULTIPLE = 128


def padded_vocab(vocab_size: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return int(-(-vocab_size // multiple) * multiple)


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def head_rms_norm(x, weight, eps: float = 1e-5):
    """qk-norm: normalize each head's vector (last dim) independently."""
    return rms_norm(x, weight, eps)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., head_dim // 2) in fp32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2). Half-split pairing:
    the first half of each head pairs with the second half."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:  # (S, half): broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def mlp(p: dict, x, activation: str):
    """Gated or plain MLP over the last dim: ``wi`` (up), ``wg`` (gate, when
    gated), ``wo`` (down). The activation runs in fp32."""
    act = activation_fn(activation)
    h = torch.matmul(x, p["wi"]).float()
    if is_gated(activation):
        h = act(torch.matmul(x, p["wg"]).float()) * h
    else:
        h = act(h)
    return torch.matmul(h.to(x.dtype), p["wo"])


def generator(device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; ``None`` on
    the ``meta`` device, where draws carry only shapes (``registry.
    param_shapes``)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(gen, shape, scale=None, dtype=torch.bfloat16, device=None):
    """Normal(0, 1) * scale drawn in fp32 from ``gen`` on ``device``, cast
    to ``dtype``. ``scale`` defaults to 1/sqrt(shape[0])."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x.mul_(scale)).to(dtype)


def cross_entropy_loss(logits, labels, vocab_size: int):
    """Mean next-token NLL over labels >= 0 (negative labels are ignored),
    in fp32; the padded vocab tail (ids >= ``vocab_size``) is masked out of
    the partition function. logits (B, S, V_pad); labels (B, S) ints."""
    lf = logits.float()
    v_pad = lf.shape[-1]
    if v_pad > vocab_size:
        tail = torch.arange(v_pad, device=lf.device) >= vocab_size
        lf = lf.masked_fill(tail, -1e30)
    logz = torch.logsumexp(lf, dim=-1)
    labels = labels.long()
    valid = labels >= 0
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)
