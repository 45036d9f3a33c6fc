"""Granite-4.0-H: Mamba-2 and attention layers in sequence, with MoE and a
shared expert in every layer (the ``granite_hybrid`` family; equations of
``transformers``' ``modeling_granitemoehybrid``).

  h = embedding_multiplier * embed(ids)
  each layer:  h = h + r * mixer(rms1(h))
               h = h + r * (moe(rms2(h)) + shared(rms2(h)))      r = residual_multiplier
  logits = rms_f(h) E^T / logits_scaling                          (E tied)

The mixer is the layer's kind (``cfg.layer_types``):
  - Mamba-2: ``in_proj`` (no bias) -> z | xBC | dt; xBC through a causal
    depthwise conv (kernel ``conv_kernel``, with bias) and SiLU, split into
    x (heads x ``ssm_head_dim``), B and C (``ssm_groups`` x ``ssm_state``);
    dt = softplus(dt + dt_bias), A = -exp(A_log); the exact scan
    ``ops.ssd_scan`` (``ops.ssd_step`` in decode), y + D x; then
    ``out_proj(norm_w * rmsnorm(y * silu(z)))``, the gated norm in fp32
    over all of ``d_inner``.
  - attention: GQA through ``transformer.attention`` with no positional
    encoding (``nope``) and scores scaled by ``attention_multiplier``.

MoE is ``moe.moe_mlp_dropless`` in the forward and prefill (every pair
reaches its expert) and ``moe.moe_mlp_decode`` in decode.

Parameters: ``layers`` holds what every layer has, stacked on all
``num_layers`` (the norms, the router, the experts, the shared expert);
``mamba`` the Mamba-2 leaves stacked on the Mamba layers and ``attn`` the
attention leaves stacked on the attention layers, in layer order.
Serving keeps, beside the KV pages of the attention layers, a state pool
indexed by slot (``init_state``): each Mamba layer's SSM state (fp32)
and its conv tail, the last ``conv_kernel - 1`` inputs of the conv.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import GraniteHybridConfig
from repro_torch.device import resolve_device
from repro_torch.hopper import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

# vocabulary rows a pass of the fp32 head (keeps its widened copy small)
HEAD_ROWS = 16384


def _check_family(cfg):
    if cfg.family != "granite_hybrid" or not isinstance(cfg, GraniteHybridConfig):
        raise ValueError(f"models.granite_hybrid runs the granite_hybrid family, got {cfg.family!r}")
    if not cfg.nope:
        raise NotImplementedError("models.granite_hybrid: attention without positions (nope) only")


def init_params(cfg, *, seed: int = 0, device=None):
    """Random parameters on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``, each leaf drawn in its own
    dtype (no fp32 copy of the experts): matrices normal with std
    1/sqrt(fan-in); the tied embedding normal with std 1 / (multiplier *
    sqrt(d_model)), so that each scaled row has unit norm and the layers,
    not the input token, set the logits; norms ones; ``A_log`` =
    log(1 .. heads), ``dt_bias`` and ``D`` ones (the published
    ``_init_weights``), the conv's weights and bias normal with std
    1/sqrt(conv_kernel). ``dt_bias``, ``A_log`` and ``D`` are fp32."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.generator(device, seed)
    dt = getattr(torch, cfg.dtype)
    d, f, fs, E = cfg.d_model, cfg.d_ff, cfg.shared_d_ff, cfg.num_experts
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    di, nh, cd = cfg.resolved_d_inner(), cfg.ssm_heads, cfg.conv_dim
    nl, nm, na = cfg.num_layers, len(cfg.layers_of("mamba")), len(cfg.layers_of("attention"))

    def normal(shape, fan_in, dtype=dt):
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return x.mul_(1.0 / math.sqrt(fan_in))

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    params = {
        "embed": normal((L.padded_vocab(cfg.vocab_size), d), cfg.embedding_multiplier ** 2 * d),
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
            "conv_w": normal((nm, cd, cfg.conv_kernel), cfg.conv_kernel),
            "conv_b": normal((nm, cd), cfg.conv_kernel),
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
    return params


def _views(group, i):
    return {k: v[i] for k, v in group.items()}


def _layers(params, cfg):
    """(i, kind, shared leaves, mixer leaves, index among its kind) per layer."""
    seen = {"mamba": 0, "attention": 0}
    shared = T.layer_views(params)
    for i, kind in enumerate(cfg.layer_types):
        j = seen[kind]
        seen[kind] += 1
        group = params["mamba"] if kind == "mamba" else params["attn"]
        yield i, kind, shared[i], _views(group, j), j


def _residual(h, out, cfg):
    return (h.float() + cfg.residual_multiplier * out.float()).to(h.dtype)


def _split_proj(pm, cfg, x):
    di, cd = cfg.resolved_d_inner(), cfg.conv_dim
    zxbcdt = torch.matmul(x, pm["in_proj"])
    return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]


def _scan_inputs(pm, cfg, xbc, dt):
    """Post-conv xBC (..., conv_dim) fp32 and raw dt (..., nh) -> x (...,
    nh, P), B and C (..., G, N), dt fp32 after softplus, A."""
    di, G, N = cfg.resolved_d_inner(), cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :di].unflatten(-1, (cfg.ssm_heads, cfg.ssm_head_dim))
    B = xbc[..., di:di + G * N].unflatten(-1, (G, N))
    C = xbc[..., di + G * N:].unflatten(-1, (G, N))
    dt = F.softplus(dt.float() + pm["dt_bias"].float())
    return x, B, C, dt, -torch.exp(pm["A_log"].float())


def _gated_out(pm, cfg, y, z, dtype):
    """out_proj(norm_w * rmsnorm(y * silu(z))), the norm in fp32."""
    g = y.flatten(-2) * F.silu(z.float())
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    return torch.matmul((pm["norm"].float() * g).to(dtype), pm["out_proj"])


def mamba_mixer(pm, cfg, x, *, layer=0, lengths=None):
    """x (B, S, d) -> (out (B, S, d), ssm state (B, nh, P, N) fp32, conv
    tail (B, conv_dim, K - 1)). With ``lengths`` (B,) the states are those
    after each row's last real token: dt is 0 past it, which leaves the
    scan's state as it was, and the tail holds the inputs before it."""
    Bt, S, _ = x.shape
    Kc = cfg.conv_kernel
    z, xbc, dt = _split_proj(pm, cfg, x)
    conv = F.conv1d(xbc.float().transpose(1, 2), pm["conv_w"].float()[:, None],
                    pm["conv_b"].float(), padding=Kc - 1, groups=cfg.conv_dim)[..., :S]
    xs, B, C, dt, A = _scan_inputs(pm, cfg, F.silu(conv.transpose(1, 2)), dt)
    ends = torch.full((Bt,), S, device=x.device) if lengths is None else lengths.to(x.device)
    if lengths is not None:
        dt = dt * (torch.arange(S, device=x.device)[None, :] < ends[:, None])[..., None]
    with tracing.span("mamba.scan", layer=layer):
        y, state = ops.ssd_scan(xs, dt, A, B, C, pm["D"])
    rows = ends[:, None] + torch.arange(Kc - 1, device=x.device)  # padded coordinates
    padded = F.pad(xbc, (0, 0, Kc - 1, 0))
    tail = padded[torch.arange(Bt, device=x.device)[:, None], rows].transpose(1, 2)
    return _gated_out(pm, cfg, y, z, x.dtype), state, tail.contiguous()


def mamba_mixer_step(pm, cfg, x, ssm, tail):
    """One token: x (B, d) -> out (B, d); ``ssm`` (B, nh, P, N) fp32 and
    ``tail`` (B, conv_dim, K - 1) advance in place."""
    z, xbc, dt = _split_proj(pm, cfg, x)
    win = torch.cat([tail, xbc[..., None].to(tail.dtype)], dim=-1)
    conv = (win.float() * pm["conv_w"].float()).sum(-1) + pm["conv_b"].float()
    tail.copy_(win[..., 1:])
    xs, B, C, dt, A = _scan_inputs(pm, cfg, F.silu(conv), dt)
    y = ops.ssd_step(xs, dt, A, B, C, pm["D"], ssm)
    return _gated_out(pm, cfg, y, z, x.dtype)


def _ffn(p, cfg, x, decode=False):
    moe = M.moe_mlp_decode(p, x, cfg) if decode else M.moe_mlp_dropless(p, x, cfg)
    return moe.float() + M.shared_expert(p, x, cfg.activation).float()


def _embed(params, cfg, tokens):
    h = params["embed"][tokens.long()]
    return (h.float() * cfg.embedding_multiplier).to(h.dtype)


def logits(params, cfg, h):
    """h (..., d) -> fp32 logits (..., V_pad): the final norm, then the
    tied head in fp32, ``HEAD_ROWS`` rows of the vocabulary a pass."""
    hf = L.rms_norm(h, params["final_norm"], cfg.norm_eps).float()
    E = params["embed"]
    parts = [torch.matmul(hf, E[i:i + HEAD_ROWS].float().T) for i in range(0, E.shape[0], HEAD_ROWS)]
    return torch.cat(parts, dim=-1) / cfg.logits_scaling


def _trunk(params, cfg, tokens, lengths=None):
    """The layers over tokens (B, S): (h (B, S, d), k/v of each attention
    layer, (ssm, tail) of each Mamba layer)."""
    h = _embed(params, cfg, tokens)
    kvs, states = [], []
    for i, kind, p, pm, _ in _layers(params, cfg):
        n = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        if kind == "mamba":
            out, ssm, tail = mamba_mixer(pm, cfg, n, layer=i, lengths=lengths)
            states.append((ssm, tail))
        else:
            out, kv = T.attention(pm, cfg, n, None, None, scale=cfg.attention_multiplier,
                                  return_kv=True)
            kvs.append(kv)
        h = _residual(h, out, cfg)
        h = _residual(h, _ffn(p, cfg, L.rms_norm(h, p["mlp_norm"], cfg.norm_eps)), cfg)
    return h, kvs, states


def forward(params, cfg, batch, **_):
    """batch {"tokens": (B, S)} -> (fp32 logits (B, S, V_pad), aux 0.0)."""
    _check_family(cfg)
    h, _, _ = _trunk(params, cfg, batch["tokens"])
    return logits(params, cfg, h), 0.0


def prefill_step(params, cfg, batch, *, lengths=None):
    """Whole prompts (B, S), the real ones ``lengths`` (B,) long (default
    S): -> (fp32 logits (B, V_pad) at each row's last real token only,
    {"k", "v"}: (n_attn, B, K, S, hd), {"ssm": (n_mamba, B, nh, P, N)
    fp32, "conv": (n_mamba, B, conv_dim, K - 1)} after the last real
    token)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    lens = (torch.full((B,), S, dtype=torch.long) if lengths is None
            else torch.as_tensor(lengths, dtype=torch.long))
    h, kvs, states = _trunk(params, cfg, tokens, lengths=None if lengths is None else lens)
    last = h[torch.arange(B, device=h.device), lens.to(h.device) - 1]
    kv = {"k": torch.stack([k for k, _ in kvs]), "v": torch.stack([v for _, v in kvs])}
    st = {"ssm": torch.stack([s for s, _ in states]), "conv": torch.stack([t for _, t in states])}
    return logits(params, cfg, last), kv, st


def init_state(cfg, slots: int, *, device=None) -> dict:
    """The state pool of ``slots`` sequences, zeros on ``device``: ``ssm``
    (n_mamba, slots, nh, P, N) fp32 and ``conv`` (n_mamba, slots,
    conv_dim, K - 1) in the activation dtype."""
    device = resolve_device(device)
    nm = len(cfg.layers_of("mamba"))
    return {
        "ssm": torch.zeros((nm, slots, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((nm, slots, cfg.conv_dim, cfg.conv_kernel - 1),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def decode_step_paged(params, cfg, cache, batch, *, state):
    """batch {"token": (B,), "position": (B,), "block_table": (B, NB)};
    ``cache`` a ``PagedKVCache`` of the attention layers; ``state`` an
    ``init_state`` pool of B slots. Every row's state and its attention
    layers' new k/v advance in place. Returns (fp32 logits (B, V_pad),
    cache)."""
    _check_family(cfg)
    position, table = batch["position"], batch["block_table"]
    h = _embed(params, cfg, batch["token"])
    for i, kind, p, pm, j in _layers(params, cfg):
        n = L.rms_norm(h, p["attn_norm"], cfg.norm_eps)
        if kind == "mamba":
            with tracing.span("mamba.step", layer=i):
                out = mamba_mixer_step(pm, cfg, n, state["ssm"][j], state["conv"][j])
        else:
            scales = ({} if cache.k_scale is None else
                      dict(k_scale=cache.k_scale[j], v_scale=cache.v_scale[j]))
            out = T.attention_decode_paged(
                pm, cfg, n, None, None, cache.k_pool[j], cache.v_pool[j], table, position,
                policy=cache.policy, scale=cfg.attention_multiplier, **scales)
        h = _residual(h, out, cfg)
        h = _residual(h, _ffn(p, cfg, L.rms_norm(h, p["mlp_norm"], cfg.norm_eps), decode=True),
                      cfg)
    return logits(params, cfg, h), cache


# the paged engine's interface (``serving/engine.py`` ``PagedModel``), as
# ``models/transformer.py`` has it


def paged_layout(cfg, slots: int, *, device=None):
    """(the window of each layer that keeps KV: the attention layers, none
    windowed; the per-slot state pool, ``init_state``)."""
    return (0,) * len(cfg.layers_of("attention")), init_state(cfg, slots, device=device)


def paged_prefill(params, cfg, tokens, length: int):
    """One prompt padded to its bucket, tokens (1, S) of which ``length``
    are real: -> (logits (V_pad,) at the last real token, {"k", "v"}:
    (n_attn, 1, K, S, hd), the slot's state after the last real token:
    {"ssm": (n_mamba, nh, P, N), "conv": (n_mamba, conv_dim, K - 1)})."""
    logits, kv, state = prefill_step(params, cfg, {"tokens": tokens}, lengths=[length])
    return logits[0], kv, {n: t[:, 0] for n, t in state.items()}


def paged_decode(params, cfg, cache, batch, state, attn_fn=None):
    """``decode_step_paged`` over the pool ``state``, on one device."""
    if attn_fn is not None:
        raise NotImplementedError("granite_hybrid decodes on one device (no attn_fn)")
    return decode_step_paged(params, cfg, cache, batch, state=state)
