"""Operations and bytes the work needs, in closed form from the shapes of a
configuration file (``configs/*.json``): each input byte read once, each
output byte written once, whatever a kernel reads again. These are the
benchmark's own counts and do not ask the program; a CPU test holds them to
the port's ``launch/step_count.py`` and ``launch/roofline.bound_ms``.

Transformer counts are for the dense block the port runs (q, k, v, o
projections, a plain or gated MLP, the head over the padded vocabulary);
attention counts the causal pairs that a query attends to.
"""
from __future__ import annotations

VOCAB_PAD = 128
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def _dims(m: dict):
    return (m["num_layers"], m["d_model"], m["num_heads"], m["num_kv_heads"],
            m["head_dim"], m["d_ff"], padded_vocab(m["vocab_size"]))


def layer_matmul_params(m: dict) -> int:
    nl, d, H, K, hd, f, vp = _dims(m)
    mlp = (3 if m["activation"] in ("swiglu", "geglu") else 2) * d * f
    return d * H * hd + 2 * d * K * hd + H * hd * d + mlp


def matmul_params(m: dict) -> int:
    """Parameters that a token multiplies by: every layer's projections and
    the head (the embedding is a lookup)."""
    nl, d, *_, vp = _dims(m)
    return nl * layer_matmul_params(m) + d * vp


def causal_pairs(s: int, offset: int = 0) -> int:
    """(query, key) pairs of ``s`` queries at positions offset..offset+s-1
    attending causally to every earlier key and themselves."""
    return s * offset + s * (s + 1) // 2


def attention_flops(m: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs in every layer and head."""
    nl, d, H, K, hd, f, vp = _dims(m)
    return 4.0 * pairs * hd * H * nl


def projection_flops(m: dict, tokens: int) -> float:
    return 2.0 * matmul_params(m) * tokens


def prefill_flops(m: dict, batch: int, seq: int) -> dict:
    """One forward of ``batch`` prompts of ``seq`` tokens, logits at every
    position: ``{"proj", "attn", "total"}``."""
    proj = projection_flops(m, batch * seq)
    attn = attention_flops(m, batch * causal_pairs(seq))
    return {"proj": proj, "attn": attn, "total": proj + attn}


def decode_flops(m: dict, contexts) -> float:
    """One decode step: one token for each sequence, ``contexts`` the keys
    each one attends to (its position + 1)."""
    return (projection_flops(m, len(contexts))
            + attention_flops(m, int(sum(contexts))))


def kv_bytes_per_token(m: dict) -> int:
    nl, d, H, K, hd, f, vp = _dims(m)
    return nl * 2 * K * hd * DTYPE_BYTES[m["dtype"]]


def weight_bytes(m: dict) -> int:
    """The projections, the head and the norms, once."""
    nl, d, *_ = _dims(m)
    return (matmul_params(m) + nl * d + d) * DTYPE_BYTES[m["dtype"]]


def decode_bytes(m: dict, contexts) -> int:
    """One decode step: every weight once, each sequence's cached keys and
    values (its own new row included) read once, the new rows written
    once, and the token embeddings and fp32 logits."""
    nl, d, H, K, hd, f, vp = _dims(m)
    kv = kv_bytes_per_token(m)
    b = len(contexts)
    return (weight_bytes(m) + kv * int(sum(contexts)) + kv * b
            + b * d * DTYPE_BYTES[m["dtype"]] + b * vp * 4)


def gcn_gemm_flops(nodes: int, f_in: int, f_out: int) -> float:
    return 2.0 * nodes * f_in * f_out


def gcn_spmm_flops(nodes: int, slots: int, features: int) -> float:
    return 2.0 * nodes * slots * features


def gcn_spmm_bytes(nodes: int, slots: int, features: int, dtype_bytes: int = 4) -> int:
    """ELL values (fp32) and int32 columns, the dense input and the output."""
    return nodes * slots * (4 + 4) + 2 * nodes * features * dtype_bytes


def gcn_forward_flops(g: dict) -> float:
    n, L, dims = g["nodes"], g["ell_slots"], g["feature_dims"]
    return sum(gcn_gemm_flops(n, a, b) + gcn_spmm_flops(n, L, b)
               for a, b in zip(dims[:-1], dims[1:]))
