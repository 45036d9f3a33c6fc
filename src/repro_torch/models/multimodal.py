"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro.models.multimodal``).

The conv frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, encoder_seq, d_model), which a
learned projection ``frontend_proj`` adapts. The encoder's blocks attend
non-causally over the frames; each decoder block runs causal
self-attention, cross-attention to the encoder's output (no rope), and the
MLP. Norms and positions are RMSNorm and rope, as in the reference. Every
attention of ``encode`` and ``forward`` goes through ``ops.flash_attention``
(the FA-2 kernel on the card), and every block through
``transformer.remat_wrap``.

Decode keeps two caches: the self-attention ``k``/``v`` (written in place,
as the dense decode does) and ``cross_k``/``cross_v`` of length
``encoder_seq``, which ``build_cross_cache`` fills once from the encoder;
the cross step reads them through ``ops.decode_attention`` at position
``encoder_seq - 1``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.hopper import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import constrain


def init_params(cfg, *, seed: int = 0, device=None):
    """Random parameters with the reference's shapes and scales, drawn on
    ``device`` (default ``cuda``) from a ``torch.Generator`` seeded with
    ``seed``, leaf by leaf in the reference's order."""
    device = resolve_device(device)
    gen = L.generator(device, seed)
    dtype = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    nl, ne = cfg.num_layers, cfg.encoder_layers
    vp = L.padded_vocab(cfg.vocab_size)

    def dense(shape, scale=None):
        return L.dense_init(gen, shape, scale=scale, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def attn(n, pre=""):
        p = {
            pre + "wq": dense((n, d, H * hd)),
            pre + "wk": dense((n, d, K * hd)),
            pre + "wv": dense((n, d, K * hd)),
            pre + "wo": dense((n, H * hd, d), scale=1.0 / math.sqrt(H * hd)),
        }
        if cfg.qkv_bias:
            for w, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
                p[pre + w] = torch.zeros((n, width), dtype=dtype, device=device)
        return p

    def mlp(n):
        p = {"mlp_norm": ones(n, d), "wi": dense((n, d, f)),
             "wo_mlp": dense((n, f, d), scale=1.0 / math.sqrt(f))}
        if L.is_gated(cfg.activation):
            p["wg"] = dense((n, d, f))
        return p

    enc_layers = {"attn_norm": ones(ne, d), **attn(ne), **mlp(ne)}
    dec_layers = {"attn_norm": ones(nl, d), "cross_norm": ones(nl, d), **attn(nl)}
    dec_layers.update(attn(nl, "c"))
    dec_layers.update(mlp(nl))
    return {
        "frontend_proj": dense((d, d)),
        "enc_layers": enc_layers,
        "enc_final_norm": ones(d),
        "embed": dense((vp, d), scale=0.02),
        "layers": dec_layers,
        "final_norm": ones(d),
        "lm_head": dense((d, vp)),
    }


def _cross_p(lp):
    p = {"wq": lp["cwq"], "wk": lp["cwk"], "wv": lp["cwv"], "wo": lp["cwo"]}
    if "cbq" in lp:
        p.update(bq=lp["cbq"], bk=lp["cbk"], bv=lp["cbv"])
    return p


def _enc_block(lp, h, cfg, cos, sin):
    n = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + T.attention(lp, cfg, n, cos, sin, causal=False)
    n = L.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    return constrain(h + T._mlp(lp, cfg, n), "residual")


def encode(params, cfg, frames):
    """frames (B, encoder_seq, d) from the stubbed conv frontend -> the
    encoder's output (B, encoder_seq, d) in the activation dtype."""
    h = torch.matmul(frames.to(getattr(torch, cfg.dtype)), params["frontend_proj"])
    h = constrain(h, "residual")
    cos, sin = T._rope(cfg, torch.arange(h.shape[1], device=h.device))
    blk = T.remat_wrap(cfg, _enc_block)
    for lp in T.layer_views({"layers": params["enc_layers"]}):
        h = blk(lp, h, cfg, cos, sin)
    return L.rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _dec_block(lp, h, enc, cfg, cos, sin, q_offset):
    n = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + T.attention(lp, cfg, n, cos, sin, causal=True, q_offset=q_offset)
    n = L.rms_norm(h, lp["cross_norm"], cfg.norm_eps)
    h = h + T.attention(_cross_p(lp), cfg, n, None, None, causal=False, kv_input=enc)
    n = L.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    return constrain(h + T._mlp(lp, cfg, n), "residual")


def forward(params, cfg, batch, *, q_offset=0):
    """batch {"frames": (B, Te, d), "tokens": (B, S)} -> (logits
    (B, S, V_pad) in the activation dtype, aux loss 0.0): the encoder over
    the frames, then the decoder over the tokens, teacher-forced."""
    enc = encode(params, cfg, batch["frames"])
    h = constrain(params["embed"][batch["tokens"].long()], "residual")
    cos, sin = T._rope(cfg, torch.arange(h.shape[1], device=h.device) + q_offset)
    blk = T.remat_wrap(cfg, _dec_block)
    for lp in T.layer_views(params):
        h = blk(lp, h, enc, cfg, cos, sin, q_offset)
    return constrain(T._logits(params, cfg, h), "logits"), 0.0


def loss_fn(params, cfg, batch, *, q_offset=0):
    logits, aux = forward(params, cfg, batch, q_offset=q_offset)
    return L.cross_entropy_loss(logits, batch["labels"], cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# decode: self-attention cache + fixed cross-attention cache
# ---------------------------------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int):
    """name -> (shape, dtype): ``k``/``v`` (nl, B, K, max_len, hd) and
    ``cross_k``/``cross_v`` (nl, B, K, encoder_seq, hd), in the config's
    dtype."""
    hd, K, nl = cfg.resolved_head_dim(), cfg.num_kv_heads, cfg.num_layers
    dt = getattr(torch, cfg.dtype)
    kv = ((nl, batch, K, max_len, hd), dt)
    cross = ((nl, batch, K, cfg.encoder_seq, hd), dt)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """Zeros of ``cache_spec`` on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in cache_spec(cfg, batch, max_len).items()}


def build_cross_cache(params, cfg, frames):
    """Run the encoder once and project its k/v for every decoder layer:
    -> (cross_k, cross_v), each (nl, B, K, encoder_seq, hd)."""
    enc = encode(params, cfg, frames)
    B, Te, _ = enc.shape
    hd, K = cfg.resolved_head_dim(), cfg.num_kv_heads
    ks, vs = [], []
    for lp in T.layer_views(params):
        k, v = torch.matmul(enc, lp["cwk"]), torch.matmul(enc, lp["cwv"])
        if "cbk" in lp:
            k, v = k + lp["cbk"], v + lp["cbv"]
        ks.append(k.to(enc.dtype).reshape(B, Te, K, hd).transpose(1, 2))
        vs.append(v.to(enc.dtype).reshape(B, Te, K, hd).transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def decode_step(params, cfg, cache, batch):
    """batch {"token": (B,), "position": (B,)} -> (logits (B, V_pad) fp32,
    cache). Each layer's self-attention k/v row is written **in place**
    into ``cache["k"][i]``/``cache["v"][i]`` at ``position``; the cross
    caches are read only. The cache passed in is returned."""
    position = batch["position"]
    hd, H = cfg.resolved_head_dim(), cfg.num_heads
    h = params["embed"][batch["token"].long()]
    B = h.shape[0]
    cos, sin = T._rope(cfg, position)
    cross_pos = torch.full((B,), cfg.encoder_seq - 1, dtype=torch.int32, device=h.device)
    for i in range(cfg.num_layers):
        lp = T._layer(params, i)
        n = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        a, _, _ = T.attention_decode(lp, cfg, n, cos, sin, cache["k"][i], cache["v"][i],
                                     position)
        h = h + a
        n = L.rms_norm(h, lp["cross_norm"], cfg.norm_eps)
        cp = _cross_p(lp)
        q = torch.matmul(n, cp["wq"])
        if "bq" in cp:
            q = q + cp["bq"]
        o = ops.decode_attention(q.reshape(B, H, hd), cache["cross_k"][i],
                                 cache["cross_v"][i], cross_pos)
        h = h + torch.matmul(o.reshape(B, H * hd), cp["wo"])
        n = L.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        h = h + T._mlp(lp, cfg, n)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    # fp32 logits, as the reference's einsum with an fp32 result
    return torch.matmul(h.float(), params["lm_head"].float()), cache
