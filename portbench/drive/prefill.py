"""Closed loop of whole-batch prefills through the port's
``models/transformer.py`` ``forward``: one client sends forward after
forward of ``batch`` prompts of ``seq`` tokens, cycling over ``batches``
token batches made in set-up, and never waits on the device between them,
so the host dispatches ahead while the card works.

The comparison takes a sample of the window's forwards (``keep``, drawn
from the seed), and from each one prompt of either half of the batch; the
reference recomputes their logits in fp32, and the number compared is the
largest relative RMS error of a prompt's logits over the real vocabulary.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.lib import counts
from portbench.lib.harness import Check


def setup(run):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer

    m, t = run.model, run.cell.traffic
    gen = torch.Generator(device=run.device).manual_seed(run.seed + 3)
    st = run.state
    st.update(
        transformer=transformer, cfg=ModelConfig(**m),
        params=run.ref.make_params(m, run.seed, run.device),
        tokens=torch.randint(0, m["vocab_size"], (t["batches"], t["batch"], t["seq"]),
                             generator=gen, device=run.device),
        flops=counts.prefill_flops(m, t["batch"], t["seq"]), n=0)
    for i in range(2):  # every shape of the loop, twice
        forward(st, i)


def forward(st, i):
    return st["transformer"].forward(st["params"], st["cfg"],
                                     {"tokens": st["tokens"][i % len(st["tokens"])]})[0]


def loop(run, seconds, keep):
    st, t = run.state, run.cell.traffic
    n0 = st["n"]
    start = time.perf_counter()
    end = start + seconds
    while True:
        with run.spans("forward"):
            logits = forward(st, st["n"])
        if keep:
            run.kept.offer((st["n"] % t["batches"], logits))
        del logits
        st["n"] += 1
        if time.perf_counter() >= end:
            break
    with run.spans("sync"):
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    n, stop = st["n"] - n0, time.perf_counter()
    return {"seconds": stop - start, "start": start, "stop": stop, "forwards": n,
            "tokens": n * t["batch"] * t["seq"], "flops": n * st["flops"]["total"]}


def end_to_end(run, w):
    return {"prefill_tok_s": w["tokens"] / w["seconds"]}


def release(run):
    """A forward keeps no state between calls: nothing to free."""


def rel_rms(x, ref) -> float:
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def check(run, control=None):
    """The sampled prompts' logits against the fp32 reference; with
    ``control="fp8"`` the reference at float8 takes the program's place."""
    st, t, m = run.state, run.cell.traffic, run.model
    rng = random.Random(run.seed)
    half = t["batch"] // 2
    picks = []  # (batch index, row, the program's logits of the row)
    for b, logits in run.kept.items:
        for lo in (0, half):
            r = rng.randrange(lo, lo + half)
            picks.append((b, r, logits[r]))
    tokens = torch.stack([st["tokens"][b, r] for b, r, _ in picks])
    V = m["vocab_size"]
    ref = run.ref.forward(st["params"], m, tokens)[..., :V]
    if control is None:
        got = [lg[..., :V].float() for _, _, lg in picks]
    else:
        got = run.ref.forward(st["params"], m, tokens, precision=control)[..., :V]
    worst = max(rel_rms(got[i], ref[i]) for i in range(len(picks)))
    return ([Check("logits_rel_rms", worst, run.limits["logits_rel_rms"])],
            run.window["forwards"], 0)
