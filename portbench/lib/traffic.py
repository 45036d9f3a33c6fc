"""The general generator of the serving mixes: request lengths from a mix's
parameters, tokens from the run's seed.

Lengths are a fixed, stratified set: ``count`` log-uniform quantiles
between ``lo`` and ``hi`` for the prompts and, independently, for the
outputs, each set put in an order drawn from the mix's ``length_seed``.
So every run's seed offers the same requests in the same order, and only
the tokens differ: the work a window holds does not change with the seed.
"""
from __future__ import annotations

import numpy as np


def loguniform_set(lo: int, hi: int, count: int, rng) -> np.ndarray:
    """``count`` quantiles (i + 0.5) / count of the log-uniform law on
    [lo, hi], rounded, in an order drawn from ``rng``."""
    u = (np.arange(count) + 0.5) / count
    lengths = np.rint(lo * (hi / lo) ** u).astype(np.int64)
    return lengths[rng.permutation(count)]


def request_lengths(mix: dict) -> list:
    """[(prompt tokens, output tokens)] of the mix, in the order it sends
    them."""
    rng = np.random.default_rng(mix["length_seed"])
    n = mix["requests"]
    prompts = loguniform_set(*mix["prompt_tokens"], n, rng)
    outputs = loguniform_set(*mix["output_tokens"], n, rng)
    return [(int(p), int(o)) for p, o in zip(prompts, outputs)]


def request_tokens(mix: dict, seed: int, vocab: int) -> list:
    """One prompt a request, its ids uniform over the vocabulary, drawn from
    ``seed``."""
    lengths = request_lengths(mix)
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, vocab, sum(p for p, _ in lengths))
    ends = np.cumsum([p for p, _ in lengths])
    return [tuple(int(t) for t in part) for part in np.split(flat, ends[:-1])]
