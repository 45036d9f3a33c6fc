"""Closed loop of whole-graph GCN forwards through the port's
``models/gcn.py`` ``forward`` (per layer ``ops.gemm`` then ``ops.spmm``):
each forward takes the next of ``features`` feature matrices made in
set-up, and the host never waits on the device between forwards.

The comparison takes a sample of the window's outputs (``keep``, drawn
from the seed); the reference recomputes each in fp32 without TF32, and the
number compared is the largest absolute error of any element over the RMS
of the reference's output.
"""
from __future__ import annotations

import time

import torch

from portbench.lib.harness import Check


def setup(run):
    from repro_torch.core.sparse import EllMatrix
    from repro_torch.models import gcn

    g, t = run.model, run.cell.traffic
    vals, cols = run.ref.make_graph(g, run.seed, run.device)
    st = run.state
    st.update(gcn=gcn, vals=vals, cols=cols,
              adj=EllMatrix(vals, cols, (g["nodes"], g["nodes"])),
              weights=run.ref.make_weights(g, run.seed, run.device),
              feats=run.ref.make_features(g, run.seed, run.device, t["features"]), n=0)
    for i in range(2):
        forward(st, i)


def forward(st, i):
    return st["gcn"].forward(st["weights"], st["adj"], st["feats"][i % len(st["feats"])])


def loop(run, seconds, keep):
    st = run.state
    n0 = st["n"]
    start = time.perf_counter()
    end = start + seconds
    while True:
        with run.spans("forward"):
            out = forward(st, st["n"])
        if keep:
            run.kept.offer((st["n"] % len(st["feats"]), out))
        del out
        st["n"] += 1
        if time.perf_counter() >= end:
            break
    with run.spans("sync"):
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    stop = time.perf_counter()
    return {"seconds": stop - start, "start": start, "stop": stop, "forwards": st["n"] - n0}


def end_to_end(run, w):
    return {"graph_forward_ms": 1e3 * w["seconds"] / w["forwards"]}


def release(run):
    """A forward keeps no state between calls: nothing to free."""


def check(run, control=None):
    """The sampled outputs against the fp32 reference; with
    ``control="tf32"`` the reference in TF32 takes the program's place."""
    st = run.state
    worst = 0.0
    for i, out in run.kept.items:
        args = (st["weights"], st["vals"], st["cols"], st["feats"][i])
        ref = run.ref.forward(*args)
        got = out.float() if control is None else run.ref.forward(*args, tf32=True)
        err = float((got - ref).abs().max() / ref.pow(2).mean().sqrt())
        worst = max(worst, err)
    return ([Check("out_max_err_over_rms", worst, run.limits["out_max_err_over_rms"])],
            run.window["forwards"], 0)
