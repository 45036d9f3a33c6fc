"""Plain PyTorch reference of granite-4.0-h-small, and the maker of the
weights both sides are handed.

The equations are those of ``transformers``' ``modeling_granitemoehybrid``
(GraniteMoeHybridForCausalLM), with nothing departed from:

  h = embedding_multiplier * E[ids]
  each layer:  h = h + r * mixer(rms1(h))
               h = h + r * (moe(rms2(h)) + shared(rms2(h)))
  logits = rms_f(h) E^T / logits_scaling

A Mamba-2 mixer projects to z | xBC | dt, runs xBC through a causal
depthwise conv with bias and SiLU, splits x (heads x P), B and C (G x N),
takes dt = softplus(dt + dt_bias) and A = -exp(A_log), scans

  S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t

exactly (chunk by chunk, the state carried from one chunk to the next;
every decay factor is exp of a sum of dt A over the tokens it spans, so at
most 1), and returns out_proj(w * rmsnorm(y * silu(z))). An attention layer
is causal GQA softmax attention with no positional encoding and scores
scaled by ``attention_multiplier``. The MoE router takes the top-k logits
and a softmax over them; each chosen expert is W_out(silu(a) * b),
[a, b] = W_in x, weighted; nothing is dropped. The experts run as a plain
loop. Everything is computed in fp32 from the served bf16 weights, with
TF32 off, one layer at a time, each layer's weights widened to fp32 only
while it runs. This file imports nothing of the port.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (per row of the left operand and per column of the right one,
scaled to e4m3's 448) before an fp32 product, the step below the bf16 the
configuration states. The scan's own arithmetic stays fp32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
CHUNK = 128  # tokens a step of the scan's chunk loop
QUERIES = 1024  # queries a block of the attention's scores


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def kinds(model: dict, kind: str) -> list:
    return [i for i, t in enumerate(model["layer_types"]) if t == kind]


def make_params(model: dict, seed: int, device) -> dict:
    """Weights in the served dtype, drawn on ``device`` from one
    ``torch.Generator`` seeded with ``seed``, one call a leaf, in the layout
    the port's ``granite_hybrid.init_params`` documents: ``layers`` stacked
    on every layer, ``mamba`` on the Mamba layers, ``attn`` on the attention
    layers. Matrices are normal with std 1/sqrt(fan-in); the tied embedding
    normal with std 1 / (embedding_multiplier * sqrt(d_model)), so each
    scaled row has unit norm; norms ones; the conv's weights and bias normal
    with std 1/sqrt(conv_kernel). ``A_log`` = log(1 .. heads), ``dt_bias``
    and ``D`` ones, as the published ``_init_weights`` sets them, in fp32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, model["dtype"])
    d, f, fs, E = model["d_model"], model["d_ff"], model["shared_d_ff"], model["num_experts"]
    H, K, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    di, N, G, P = model["d_inner"], model["ssm_state"], model["ssm_groups"], model["ssm_head_dim"]
    nh, Kc = di // P, model["conv_kernel"]
    cd = di + 2 * G * N
    nl, nm, na = model["num_layers"], len(kinds(model, "mamba")), len(kinds(model, "attention"))

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return x.mul_(1.0 / math.sqrt(fan_in))

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "embed": normal((padded_vocab(model["vocab_size"]), d),
                        model["embedding_multiplier"] ** 2 * d),
        "final_norm": full((d,), 1.0),
        "layers": {
            "attn_norm": full((nl, d), 1.0), "mlp_norm": full((nl, d), 1.0),
            "router": normal((nl, d, E), d),
            "moe_wg": normal((nl, E, d, f), d), "moe_wi": normal((nl, E, d, f), d),
            "moe_wo": normal((nl, E, f, d), f),
            "sh_wg": normal((nl, d, fs), d), "sh_wi": normal((nl, d, fs), d),
            "sh_wo": normal((nl, fs, d), fs),
        },
        "mamba": {
            "in_proj": normal((nm, d, di + cd + nh), d),
            "conv_w": normal((nm, cd, Kc), Kc),
            "conv_b": normal((nm, cd), Kc),
            "dt_bias": full((nm, nh), 1.0, torch.float32),
            "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=device)
                               ).expand(nm, nh).contiguous(),
            "D": full((nm, nh), 1.0, torch.float32),
            "norm": full((nm, di), 1.0),
            "out_proj": normal((nm, di, d), di),
        },
        "attn": {
            "wq": normal((na, d, H * hd), d), "wk": normal((na, d, K * hd), d),
            "wv": normal((na, d, K * hd), d), "wo": normal((na, H * hd, d), H * hd),
        },
    }


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


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _scan(x, dt, A, B, C, D):
    """The exact scan over one sequence: x (S, nh, P), dt (S, nh), A (nh,),
    B, C (S, G, N), D (nh,) -> y (S, nh, P). Chunk by chunk: inside a chunk
    the decays between tokens are exp of segment sums of dt A; the state
    entering it is carried from the chunk before."""
    S, nh, P = x.shape
    G, N = B.shape[-2:]
    g = torch.arange(nh, device=x.device) // (nh // G)
    state = x.new_zeros(nh, P, N)
    out = []
    for lo in range(0, S, CHUNK):
        xs, dts = x[lo:lo + CHUNK], dt[lo:lo + CHUNK]
        Bs, Cs = B[lo:lo + CHUNK][:, g], C[lo:lo + CHUNK][:, g]  # (T, nh, N)
        T = xs.shape[0]
        a = (dts * A).T  # (nh, T)
        # seg[:, t, s] = sum(a[:, s+1 .. t]), a cumulative sum over t of a
        # masked to r > s, and -inf (no decay path) for s > t
        tri = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        seg = torch.cumsum(a[:, :, None].expand(nh, T, T).masked_fill(~tri.tril(-1), 0), dim=1)
        decay = torch.exp(seg.masked_fill(~tri, float("-inf")))  # (nh, t, s)
        scores = torch.einsum("thn,shn->hts", Cs, Bs) * decay
        y = torch.einsum("hts,sh,shp->thp", scores, dts, xs)
        into = torch.exp(torch.cumsum(a, dim=1))  # decay from the chunk's start to t
        y = y + torch.einsum("thn,hpn,ht->thp", Cs, state, into)
        to_end = torch.exp(seg[:, -1])  # (nh, s): decay from s to the chunk's end
        state = (state * into[:, -1, None, None]
                 + torch.einsum("hs,sh,shp,shn->hpn", to_end, dts, xs, Bs))
        out.append(y)
    return torch.cat(out) + D[:, None] * x


def _mamba(w, model, x, precision):
    """x (B, S, d) fp32 -> (B, S, d)."""
    Bt, S, _ = x.shape
    di, N, G, P = model["d_inner"], model["ssm_state"], model["ssm_groups"], model["ssm_head_dim"]
    nh, Kc = di // P, model["conv_kernel"]
    proj = _mm(x, w["in_proj"], precision)
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * G * N], proj[..., 2 * di + 2 * G * N:]
    conv = F.conv1d(xbc.transpose(1, 2), w["conv_w"][:, None], w["conv_b"], padding=Kc - 1,
                    groups=xbc.shape[-1])[..., :S]
    xbc = F.silu(conv.transpose(1, 2))
    xs = xbc[..., :di].reshape(Bt, S, nh, P)
    Bm = xbc[..., di:di + G * N].reshape(Bt, S, G, N)
    Cm = xbc[..., di + G * N:].reshape(Bt, S, G, N)
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    y = torch.stack([_scan(xs[b], dt[b], A, Bm[b], Cm[b], w["D"]) for b in range(Bt)])
    g = y.reshape(Bt, S, di) * F.silu(z)
    return _mm(_rms(g, w["norm"], model["norm_eps"]), w["out_proj"], precision)


def _attention(w, model, x, precision):
    """Causal GQA, no positional encoding; queries in blocks of QUERIES."""
    Bt, S, _ = x.shape
    H, K, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = _mm(x, w["wq"], precision).view(Bt, S, H, hd).transpose(1, 2)
    k = _mm(x, w["wk"], precision).view(Bt, S, K, hd).transpose(1, 2)
    v = _mm(x, w["wv"], precision).view(Bt, S, K, hd).transpose(1, 2)
    k, v = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    kt = k.transpose(-1, -2)
    if precision == "fp8":
        kt = _fp8(kt, -2)
    out = []
    for lo in range(0, S, QUERIES):
        qb = q[:, :, lo:lo + QUERIES]
        if precision == "fp8":
            qb = _fp8(qb, -1)
        s = torch.matmul(qb, kt) * model["attention_multiplier"]
        rows = torch.arange(lo, lo + qb.shape[2], device=x.device)[:, None]
        s = s.masked_fill(torch.arange(S, device=x.device)[None, :] > rows, float("-inf"))
        out.append(_mm(torch.softmax(s, dim=-1), v, precision))
    o = torch.cat(out, dim=2).transpose(1, 2).reshape(Bt, S, H * hd)
    return _mm(o, w["wo"], precision)


def _moe(w, model, x, precision):
    """Top-k of the router's logits, softmax over them, the chosen experts
    in a plain loop, every pair kept; plus the shared expert."""
    E, k = model["num_experts"], model["experts_per_token"]
    flat = x.reshape(-1, x.shape[-1])
    top, idx = torch.topk(_mm(flat, w["router"], precision), k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(flat)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            xe = flat[tok]
            h = F.silu(_mm(xe, w["moe_wg"][e], precision)) * _mm(xe, w["moe_wi"][e], precision)
            out.index_add_(0, tok, _mm(h, w["moe_wo"][e], precision) * gates[tok, slot, None])
    shared = _mm(F.silu(_mm(flat, w["sh_wg"], precision)) * _mm(flat, w["sh_wi"], precision),
                 w["sh_wo"], precision)
    return (out + shared).view(x.shape)


@torch.no_grad()
def forward(params: dict, model: dict, tokens, *, precision: str = "fp32", start: int = 0):
    """tokens (B, S) ints -> fp32 logits (B, S - start, padded vocab) of the
    positions from ``start`` on, layer by layer."""
    eps, r = model["norm_eps"], model["residual_multiplier"]
    mixers = {"mamba": iter(range(len(kinds(model, "mamba")))),
              "attention": iter(range(len(kinds(model, "attention"))))}
    with exact_fp32():
        h = params["embed"][tokens.long()].float() * model["embedding_multiplier"]
        for i, kind in enumerate(model["layer_types"]):
            j = next(mixers[kind])
            group = params["mamba"] if kind == "mamba" else params["attn"]
            w = {n: t[j].float() for n, t in group.items()}
            w.update({n: t[i].float() for n, t in params["layers"].items()})
            x = _rms(h, w["attn_norm"], eps)
            mix = _mamba if kind == "mamba" else _attention
            h = h + r * mix(w, model, x, precision)
            h = h + r * _moe(w, model, _rms(h, w["mlp_norm"], eps), precision)
            del w, x
        h = _rms(h[:, start:], params["final_norm"].float(), eps)
        E = params["embed"]
        parts = [_mm(h, E[i:i + 16384].float().T, precision) for i in range(0, E.shape[0], 16384)]
        return torch.cat(parts, dim=-1) / model["logits_scaling"]
