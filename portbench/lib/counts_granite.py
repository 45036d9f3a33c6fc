"""Operations and bytes of granite-4.0-h-small's work, in closed form from
the shapes of its configuration file (``configs/granite-4.0-h-small.json``,
``model``), as ``counts.py`` gives them for the dense transformer: each
input byte read once, each output byte written once, model FLOPs only (a
token multiplies by the experts it routes to, not by every expert a
kernel may run).

A Mamba layer's scan counts the recurrence's own arithmetic, 4 nh P N a
token (the state's decay and update, and its read-out), not the chunked
form's. The head is counted once a prefill (its last row, the one that is
sampled) and once a decoded token.
"""
from __future__ import annotations

from portbench.lib.counts import DTYPE_BYTES, causal_pairs, padded_vocab


def _sizes(m: dict) -> dict:
    di, P, N, G = m["d_inner"], m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    types = m["layer_types"]
    return dict(d=m["d_model"], nh=di // P, di=di, P=P, N=N, cd=di + 2 * G * N,
                nm=types.count("mamba"), na=types.count("attention"), nl=len(types),
                hq=m["num_heads"] * m["head_dim"], hkv=m["num_kv_heads"] * m["head_dim"],
                vp=padded_vocab(m["vocab_size"]), E=m["num_experts"], k=m["experts_per_token"],
                f=m["d_ff"], fs=m["shared_d_ff"], Kc=m["conv_kernel"],
                by=DTYPE_BYTES[m["dtype"]])


def token_matmul_params(m: dict) -> int:
    """Parameters one token multiplies by in the layers: every Mamba
    layer's in and out projections, every attention layer's q, k, v and o,
    every layer's router, its k routed experts and the shared expert."""
    s = _sizes(m)
    mamba = s["d"] * (s["di"] + s["cd"] + s["nh"]) + s["di"] * s["d"]
    attn = 2 * s["d"] * s["hq"] + 2 * s["d"] * s["hkv"]
    ffn = s["d"] * s["E"] + 3 * s["d"] * (s["k"] * s["f"] + s["fs"])
    return s["nm"] * mamba + s["na"] * attn + s["nl"] * ffn


def scan_flops(m: dict, tokens: int) -> float:
    """The recurrence over ``tokens`` tokens in every Mamba layer, and the
    depthwise conv."""
    s = _sizes(m)
    return float(tokens) * s["nm"] * (4 * s["nh"] * s["P"] * s["N"] + 2 * s["cd"] * s["Kc"])


def attention_flops(m: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs in each attention layer."""
    s = _sizes(m)
    return 4.0 * pairs * s["hq"] * s["na"]


def head_flops(m: dict, rows: int) -> float:
    s = _sizes(m)
    return 2.0 * rows * s["d"] * s["vp"]


def prefill_flops(m: dict, prompt: int) -> float:
    """One prompt's prefill: every token through the layers, causal
    attention, the head at the last token."""
    return (2.0 * token_matmul_params(m) * prompt + scan_flops(m, prompt)
            + attention_flops(m, causal_pairs(prompt)) + head_flops(m, 1))


def decode_flops(m: dict, contexts) -> float:
    """One decode step: one token for each sequence, ``contexts`` the keys
    each one attends to (its position + 1)."""
    b = len(contexts)
    return (2.0 * token_matmul_params(m) * b + scan_flops(m, b)
            + attention_flops(m, int(sum(contexts))) + head_flops(m, b))


def experts_hit(m: dict, tokens: int) -> float:
    """The experts of a layer that ``tokens`` tokens route to, expected
    under uniform routing: E (1 - (1 - k / E) ^ tokens)."""
    s = _sizes(m)
    return s["E"] * (1.0 - (1.0 - s["k"] / s["E"]) ** tokens)


def weight_bytes(m: dict, tokens: int) -> float:
    """The weights a step of ``tokens`` tokens reads once: everything but
    the routed experts, and of those the ones the tokens route to."""
    s = _sizes(m)
    mamba = (s["d"] * (s["di"] + s["cd"] + s["nh"]) + s["di"] * s["d"] + s["cd"] * (s["Kc"] + 1)
             + s["di"]) * s["by"] + 3 * s["nh"] * 4
    attn = (2 * s["d"] * s["hq"] + 2 * s["d"] * s["hkv"]) * s["by"]
    fixed = (s["d"] * s["E"] + 3 * s["d"] * s["fs"] + 2 * s["d"]) * s["by"]
    expert = 3 * s["d"] * s["f"] * s["by"]
    return (s["nm"] * mamba + s["na"] * attn + s["nl"] * (fixed + experts_hit(m, tokens) * expert)
            + (s["vp"] * s["d"] + s["d"]) * s["by"])


def state_bytes(m: dict) -> int:
    """One sequence's recurrent state: every Mamba layer's fp32 SSM state
    and its conv tail."""
    s = _sizes(m)
    return s["nm"] * (s["nh"] * s["P"] * s["N"] * 4 + s["cd"] * (s["Kc"] - 1) * s["by"])


def kv_bytes_per_token(m: dict) -> int:
    s = _sizes(m)
    return s["na"] * 2 * s["hkv"] * s["by"]


def decode_bytes(m: dict, contexts) -> float:
    """One decode step: the weights the step's tokens need once, each
    sequence's state read and written, its cached keys and values (its
    new row included) read once and the new rows written once, and the
    token embeddings and fp32 logits."""
    s = _sizes(m)
    b = len(contexts)
    kv = kv_bytes_per_token(m)
    return (weight_bytes(m, b) + 2 * state_bytes(m) * b + kv * int(sum(contexts)) + kv * b
            + b * s["d"] * s["by"] + b * s["vp"] * 4)
