"""RWKV6 ("Finch"), the ssm family (port of ``repro.models.ssm``).

Attention-free LM with data-dependent per-channel decay. The time-mix runs
the chunked linear-attention scan ``ops.linear_attention`` (the Hopper
kernel ``csrc/linear_attention.cu`` on the card) over the whole sequence;
decode advances the constant-size state one token at a time through
``ops.linear_attention_step``, as the reference does. Token-shift mixing
uses static interpolation factors; channel-mix is the squared-ReLU FFN.

Parameters are a plain dict of tensors with the reference's layout (the
per-layer leaves stacked on a leading ``num_layers`` axis). Projections are
``torch.matmul`` in the activation dtype, as ``models/layers.py`` says;
the decay's low-rank projection runs on fp32 copies of its bf16 operands,
which is the reference's fp32-result einsum exactly. The token shift takes
the reference's halo exchange on a sequence-sharded mesh (``_shift``):
each ``model`` rank shifts its own sequence chunk and receives only the
previous rank's last column, through ``collectives.ppermute``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.hopper import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import params_from_jax  # noqa: F401  (the family's API)
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

LORA_RANK = 64


def _num_heads(cfg) -> int:
    return cfg.d_model // cfg.resolved_head_dim()


def _check_family(cfg):
    if cfg.family != "ssm":
        raise ValueError(f"models.ssm runs the ssm family, got {cfg.family!r}")


def init_params(cfg, *, seed: int = 0, device=None):
    """Random parameters with the reference's shapes, dtypes and scales,
    drawn on ``device`` (default ``cuda``; raises without CUDA unless a
    device is given) from a ``torch.Generator`` seeded with ``seed``."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.generator(device, seed)
    dtype = getattr(torch, cfg.dtype)
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    N, H = cfg.resolved_head_dim(), _num_heads(cfg)
    vp = L.padded_vocab(cfg.vocab_size)

    def dense(shape, scale=None, dt=dtype):
        return L.dense_init(gen, shape, scale=scale, dtype=dt, device=device)

    def full(value, *shape):
        return torch.full(shape or (nl, d), value, dtype=dtype, device=device)

    layers = {
        "tm_norm": full(1.0),
        "cm_norm": full(1.0),
        **{f"mu_{n}": full(0.5) for n in ("r", "k", "v", "g", "w", "ck", "cr")},
        **{f"w{n}_t": dense((nl, d, d)) for n in ("r", "k", "v", "g", "o")},
        # fp32: decay dynamics are sensitive
        "w0": torch.linspace(-5.0, -0.5, d, dtype=torch.float32, device=device).repeat(nl, 1),
        "w_lora_a": dense((nl, d, LORA_RANK), scale=0.01),
        "w_lora_b": dense((nl, LORA_RANK, d), scale=0.01),
        "u": dense((nl, H, N), scale=0.5, dt=torch.float32),
        "ln_x": full(1.0),
        "wk_c": dense((nl, d, f)),
        "wv_c": dense((nl, f, d), scale=1.0 / math.sqrt(f)),
        "wr_c": dense((nl, d, d)),
    }
    return {
        "embed": dense((vp, d), scale=0.02),
        "layers": layers,
        "final_norm": full(1.0, d),
        "lm_head": dense((d, vp)),
    }


def _layer(params, i):
    return {k: v[i] for k, v in params["layers"].items()}


def _shift(x, cfg=None):
    """Token shift (B, S, d): x_prev[t] = x[t - 1], zero at the start.

    With ``cfg.halo_shift`` under a current mesh, ``seq_shard_activations``
    and S divisible by the ``model`` axis, the reference's halo exchange:
    every rank holds its (B / data, S / model, d) chunk (the batch split
    over the data axes where it divides, else whole), sends only its last
    column to the next ``model`` rank (``collectives.ppermute``; rank 0
    receives zeros, the sequence start) and shifts locally. The chunks are
    gathered back into the global tensor: bitwise the plain shift."""
    mesh = sh.current_mesh() if cfg is not None and cfg.halo_shift else None
    if mesh is None or not cfg.seq_shard_activations or x.shape[1] % mesh.shape["model"]:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    n = mesh.shape["model"]
    dp = sh.pick(mesh, x.shape[0], sh.dp_axes(mesh))
    spec = sh.P(dp, "model", None)
    parts = mesh.shard_spec(x, spec)
    prev = collectives.ppermute([xl[:, -1:] for xl in parts], mesh, "model",
                                [(i, i + 1) for i in range(n - 1)])
    outs = []
    for r, (xl, pl) in enumerate(zip(parts, prev)):
        with mesh.on(r):
            outs.append(torch.cat([pl, xl[:, :-1]], dim=1))
    return mesh.gather_spec(outs, spec, x.device)


def _heads(x, H, N):  # (B, S, H*N) -> (B, H, S, N), a view
    B, S, _ = x.shape
    return x.reshape(B, S, H, N).transpose(1, 2)


def _unheads(x):  # (B, H, S, N) -> (B, S, H*N)
    B, H, S, N = x.shape
    return x.transpose(1, 2).reshape(B, S, H * N)


def _decay_log(p, mixed_w):
    """w_log = -exp(w0 + tanh(x A) B), the Finch data-dependent decay, fp32."""
    a = torch.matmul(mixed_w.float(), p["w_lora_a"].float())
    lora = torch.matmul(torch.tanh(a), p["w_lora_b"].float())
    return -torch.exp(p["w0"] + lora)


def time_mix_inputs(p, cfg, x, x_prev):
    """The scan's inputs of one time-mix: r, k, v (B, H, S, N) in the
    activation dtype and w_log (B, H, S, N) fp32, all transposed views of
    (B, S, H*N) tensors, and the gate g (B, S, d)."""
    N, H = cfg.resolved_head_dim(), _num_heads(cfg)

    def mix(mu):
        return x * mu + x_prev * (1.0 - mu)

    r = torch.matmul(mix(p["mu_r"]), p["wr_t"])
    k = torch.matmul(mix(p["mu_k"]), p["wk_t"])
    v = torch.matmul(mix(p["mu_v"]), p["wv_t"])
    g = torch.matmul(mix(p["mu_g"]), p["wg_t"])
    w_log = _decay_log(p, mix(p["mu_w"]))
    return (*(_heads(t, H, N) for t in (r, k, v, w_log)), g)


def time_mix(p, cfg, x, x_prev, state=None):
    """x (B, S, d); state (B, H, N, N) incoming wkv state (None: zeros).
    Returns (out (B, S, d), final state fp32)."""
    N, H = cfg.resolved_head_dim(), _num_heads(cfg)
    r, k, v, w_log, g = time_mix_inputs(p, cfg, x, x_prev)
    o, S = ops.linear_attention(r, k, v, w_log, p["u"], s0=state)
    o = _unheads(o)
    B_, S_, _ = o.shape
    # per-head group norm + learned scale
    o = L.rms_norm(o.reshape(B_, S_, H, N), torch.ones(N, dtype=o.dtype, device=o.device),
                   cfg.norm_eps)
    o = (o.reshape(B_, S_, H * N) * p["ln_x"]).to(x.dtype)
    o = o * F.silu(g.float()).to(x.dtype)
    return torch.matmul(o, p["wo_t"]), S


def channel_mix(p, cfg, x, x_prev):
    def mix(mu):
        return x * mu + x_prev * (1.0 - mu)

    kk = torch.square(F.relu(torch.matmul(mix(p["mu_ck"]), p["wk_c"]).float())).to(x.dtype)
    out = torch.matmul(kk, p["wv_c"])
    rr = torch.sigmoid(torch.matmul(mix(p["mu_cr"]), p["wr_c"]).float()).to(x.dtype)
    return rr * out


def block(p, cfg, h):
    x = L.rms_norm(h, p["tm_norm"], cfg.norm_eps)
    o, _ = time_mix(p, cfg, x, _shift(x, cfg))
    h = h + o
    x = L.rms_norm(h, p["cm_norm"], cfg.norm_eps)
    h = h + channel_mix(p, cfg, x, _shift(x, cfg))
    return constrain(h, "residual")


def forward(params, cfg, batch, *, q_offset=0):
    """batch {"tokens": (B, S)} -> (logits (B, S, V_pad) in the activation
    dtype, aux loss 0.0). ``q_offset`` is accepted for the family API and
    unused: the token shift carries no positions. Under grad each block
    runs through ``transformer.remat_wrap``."""
    del q_offset
    _check_family(cfg)
    h = constrain(params["embed"][batch["tokens"].long()], "residual")
    blk = T.remat_wrap(cfg, block)
    for p in T.layer_views(params):
        h = blk(p, cfg, h)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return constrain(torch.matmul(h, params["lm_head"]), "logits"), 0.0


def loss_fn(params, cfg, batch, *, q_offset=0):
    logits, aux = forward(params, cfg, batch, q_offset=q_offset)
    return L.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# decode: constant-size state (B, H, N, N) + two token-shift states
# ---------------------------------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int):
    """name -> (shape, dtype) of the decode state; ``max_len`` is unused
    (the state's size is constant: the point of the family)."""
    del max_len
    d, N, H, nl = cfg.d_model, cfg.resolved_head_dim(), _num_heads(cfg), cfg.num_layers
    dt = getattr(torch, cfg.dtype)
    return {
        "ssm_state": ((nl, batch, H, N, N), torch.float32),
        "ts_time": ((nl, batch, d), dt),
        "ts_chan": ((nl, batch, d), dt),
    }


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zeros of ``cache_spec`` on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in cache_spec(cfg, batch, max_len).items()}


def decode_step(params, cfg, cache, batch):
    """batch {"token": (B,)} -> (logits (B, V_pad) fp32, cache). The cache's
    tensors are updated in place and returned."""
    _check_family(cfg)
    N, H = cfg.resolved_head_dim(), _num_heads(cfg)
    h = params["embed"][batch["token"].long()]  # (B, d)
    ones_n = torch.ones(N, dtype=h.dtype, device=h.device)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        ts1, ts2 = cache["ts_time"][i], cache["ts_chan"][i]
        x = L.rms_norm(h, lp["tm_norm"], cfg.norm_eps)

        def mix(mu, xp):
            return x * mu + xp * (1.0 - mu)

        r = torch.matmul(mix(lp["mu_r"], ts1), lp["wr_t"])
        k = torch.matmul(mix(lp["mu_k"], ts1), lp["wk_t"])
        v = torch.matmul(mix(lp["mu_v"], ts1), lp["wv_t"])
        g = torch.matmul(mix(lp["mu_g"], ts1), lp["wg_t"])
        wl = -torch.exp(lp["w0"] + torch.matmul(
            torch.tanh(torch.matmul(mix(lp["mu_w"], ts1), lp["w_lora_a"])), lp["w_lora_b"]))
        o, S = ops.linear_attention_step(
            *(t.reshape(-1, H, N) for t in (r, k, v, wl)), lp["u"], cache["ssm_state"][i])
        o = L.rms_norm(o, ones_n, cfg.norm_eps)
        o = (o.reshape(-1, H * N) * lp["ln_x"]).to(h.dtype)
        o = o * F.silu(g.float()).to(h.dtype)
        h = h + torch.matmul(o, lp["wo_t"])
        x2 = L.rms_norm(h, lp["cm_norm"], cfg.norm_eps)

        def mix2(mu):
            return x2 * mu + ts2 * (1.0 - mu)

        kk = torch.square(F.relu(torch.matmul(mix2(lp["mu_ck"]), lp["wk_c"]))).to(h.dtype)
        out = torch.matmul(kk, lp["wv_c"])
        rr = torch.sigmoid(torch.matmul(mix2(lp["mu_cr"]), lp["wr_c"])).to(h.dtype)
        h = h + rr * out
        cache["ssm_state"][i].copy_(S)
        ts1.copy_(x)
        ts2.copy_(x2)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    # fp32 logits, as the reference's einsum with an fp32 result
    return torch.matmul(h.float(), params["lm_head"].float()), cache
