"""Plain PyTorch reference of occamy-gptj as the port states its function,
and the maker of the weights both sides are handed.

The block is GPT-J-6B's parallel-residual block with the port's stated
departures (``configs/occamy-gptj.json``, ``departures``): RMS norm
without bias, rotary embedding over the whole head (half-split pairs,
theta 10000), no biases, a head over the vocabulary padded to a multiple
of 128. Everything is computed in fp32 from the served bf16 weights, with
TF32 off; attention is the textbook softmax over causal scores. This file
imports nothing of the port.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (per row of the left operand and per column of the right one,
scaled to e4m3's 448) before an fp32 product, the step below the bf16 the
configuration states.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def make_params(model: dict, seed: int, device) -> dict:
    """Weights in the served dtype, drawn on ``device`` from one
    ``torch.Generator`` seeded with ``seed``, one call a leaf, in the layout
    the port's ``transformer.init_params`` documents (each layer leaf
    stacked on a leading ``num_layers`` axis). Each matrix is normal with
    std 1/sqrt(fan-in), so every layer's output has about unit scale; the
    embedding is unit normal and the norms are ones."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, model["dtype"])
    nl, d, f = model["num_layers"], model["d_model"], model["d_ff"]
    hq = model["num_heads"] * model["head_dim"]
    hkv = model["num_kv_heads"] * model["head_dim"]
    vp = padded_vocab(model["vocab_size"])

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return x.mul_(1.0 / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(nl, d),
        "wq": normal((nl, d, hq), d),
        "wk": normal((nl, d, hkv), d),
        "wv": normal((nl, d, hkv), d),
        "wo": normal((nl, hq, d), hq),
        "wi": normal((nl, d, f), d),
        "wo_mlp": normal((nl, f, d), f),
    }
    return {"embed": normal((vp, d), 1), "layers": layers,
            "final_norm": ones(d), "lm_head": normal((d, vp), d)}


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _fp8(x, dim):
    """x rounded to e4m3 at a scale per slice along ``dim``, back in fp32."""
    scale = E4M3_MAX / x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _mm(a, b, precision):
    """a (..., K) @ b (K, N) or (..., K, N)."""
    if precision == "fp8":
        a, b = _fp8(a, -1), _fp8(b, -2)
    return torch.matmul(a, b)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """x (B, S, H, D): half-split pairs over the whole head."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, precision):
    """Causal softmax attention; q, k, v (B, S, H, D) -> (B, S, H, D)."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    S = q.shape[2]
    kt = k.transpose(-1, -2)
    if precision == "fp8":
        q, kt = _fp8(q, -1), _fp8(kt, -2)
    s = torch.matmul(q, kt) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return _mm(p, v, precision).transpose(1, 2)


@torch.no_grad()
def forward(params: dict, model: dict, tokens, *, precision: str = "fp32"):
    """tokens (B, S) ints -> fp32 logits (B, S, padded vocab), layer by
    layer, each layer's weights widened to fp32 only while it runs."""
    B, S = tokens.shape
    nl, eps, theta = model["num_layers"], model["norm_eps"], model["rope_theta"]
    H, K, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    pos = torch.arange(S, device=tokens.device)
    with exact_fp32():
        h = params["embed"][tokens.long()].float()
        for i in range(nl):
            w = {n: t[i].float() for n, t in params["layers"].items()}
            x = _rms_norm(h, w["attn_norm"], eps)
            q = _rope(_mm(x, w["wq"], precision).view(B, S, H, hd), pos, theta)
            k = _rope(_mm(x, w["wk"], precision).view(B, S, K, hd), pos, theta)
            v = _mm(x, w["wv"], precision).view(B, S, K, hd)
            if K != H:
                k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
            a = _mm(_attention(q, k, v, precision).reshape(B, S, H * hd), w["wo"], precision)
            m = _mm(F.gelu(_mm(x, w["wi"], precision), approximate="tanh"), w["wo_mlp"],
                    precision)
            h = h + a + m
            del w, x, q, k, v, a, m
        h = _rms_norm(h, params["final_norm"].float(), eps)
        return _mm(h, params["lm_head"].float(), precision)
