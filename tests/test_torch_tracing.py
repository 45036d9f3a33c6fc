"""The port's tracer (``repro_torch.tracing``) and the spans and page
counters it keeps in the serving path, on the CPU.

- Off (no profiler), ``span`` hands out one shared null context and keeps
  nothing.
- Under ``torch.profiler``, records nest with the ids of the spans open
  around them.
- REDUCED ``occamy-gptj`` served through ``ServingEngine.with_model(
  device="cpu")``: each step is one ``engine.step`` holding one
  ``engine.decode``, which holds one ``decode.pages`` a layer and one
  ``decode.fetch``; each admission is one ``engine.prefill`` with its
  request's id; the page counters equal a count by hand from the slots'
  positions; the served tokens are the same with the profiler on and off.
"""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.base import get_config
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServingEngine

GEOMETRY = dict(num_blocks=40, block_size=4, max_slots=3, max_blocks_per_seq=4)


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_store():
    tracing.take()
    yield
    tracing.take()


def test_off_keeps_nothing():
    assert not tracing.live()
    a, b = tracing.span("a", k=1), tracing.span("b")
    assert a is b
    with a:
        with b:
            pass
    assert tracing.take() == []


def test_records_nest_under_a_profiler():
    with profiled():
        assert tracing.live()
        with tracing.span("outer", n=3):
            with tracing.span("inner"):
                pass
            with tracing.span("inner"):
                pass
        with tracing.span("top"):
            pass
    assert not tracing.live()
    recs = tracing.take()
    assert tracing.take() == []
    assert [r.name for r in recs] == ["inner", "inner", "outer", "top"]
    i1, i2, outer, top = recs
    assert outer.parent is None and top.parent is None
    assert i1.parent == outer.id and i2.parent == outer.id
    assert len({r.id for r in recs}) == 4
    assert outer.attrs == {"n": 3} and i1.attrs == {}
    assert outer.start <= i1.start <= i1.end <= i2.start <= i2.end <= outer.end <= top.start


@pytest.fixture(scope="module")
def gptj():
    cfg = get_config("occamy-gptj", reduced=True)
    return cfg, transformer.init_params(cfg, seed=0, device="cpu")


def _requests():
    rng = np.random.default_rng(3)
    return [Request(rid=rid, prompt=tuple(int(x) for x in rng.integers(1, 512, int(rng.integers(3, 9)))),
                    max_new_tokens=5, arrival=rid // 2)
            for rid in range(5)]


def _serve(cfg, params, traced: bool):
    """Serve the requests to the end; returns (tokens, records, per-step
    decode inputs (positions, active, table shape))."""
    eng = ServingEngine.with_model(cfg, params, device="cpu", **GEOMETRY)
    seen = []
    decode = eng.model.decode

    def watched(tokens, positions, tables, active):
        seen.append((positions.copy(), active.copy(), tables.shape))
        return decode(tokens, positions, tables, active)

    eng.model.decode = watched
    for r in _requests():
        eng.submit(r)
    if traced:
        with profiled():
            out = eng.run(max_steps=200)
    else:
        out = eng.run(max_steps=200)
    assert eng.leaked_blocks() == 0
    return out, tracing.take(), seen, eng


def test_serving_spans_per_step(gptj):
    cfg, params = gptj
    out, recs, seen, eng = _serve(cfg, params, traced=True)
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "engine.step"]
    assert [r.attrs["step"] for r in steps] == list(range(eng.step_count))
    assert all(r.parent is None for r in steps)

    def children(parent, name):
        return [r for r in recs if r.parent == parent.id and r.name == name]

    decodes = []
    for s in steps:
        (d,) = children(s, "engine.decode")
        decodes.append(d)
        assert len(children(d, "decode.pages")) == cfg.num_layers
        assert len(children(d, "decode.fetch")) == 1
        assert s.start <= d.start <= d.end <= s.end
    assert len(decodes) == len(seen)

    admitted = {e[2]: e[1] for e in eng.scheduler.events if e[0] == "admit"}
    prefills = [r for r in recs if r.name == "engine.prefill"]
    assert sorted(r.attrs["rid"] for r in prefills) == sorted(admitted) == sorted(out)
    for r in prefills:
        assert by_id[r.parent].name == "engine.step"
        assert by_id[r.parent].attrs["step"] == admitted[r.attrs["rid"]]
    assert {r.name for r in recs} == {"engine.step", "engine.prefill", "engine.decode",
                                      "decode.pages", "decode.fetch"}


def test_page_counters_match_a_hand_count(gptj):
    cfg, params = gptj
    _, recs, seen, _ = _serve(cfg, params, traced=True)
    decodes = [r for r in recs if r.name == "engine.decode"]
    bs, L = GEOMETRY["block_size"], cfg.num_layers
    for d, (positions, active, shape) in zip(decodes, seen, strict=True):
        live = sum(math.ceil((int(p) + 1) / bs) for p in positions[active])
        assert d.attrs == {"pages_live": live * L,
                           "pages_walked": GEOMETRY["max_slots"] * GEOMETRY["max_blocks_per_seq"] * L}
        assert shape == (GEOMETRY["max_slots"], GEOMETRY["max_blocks_per_seq"])
    assert 0 < sum(d.attrs["pages_live"] for d in decodes) < sum(
        d.attrs["pages_walked"] for d in decodes)


def test_served_tokens_do_not_depend_on_the_profiler(gptj):
    cfg, params = gptj
    plain, none, _, _ = _serve(cfg, params, traced=False)
    traced, recs, _, _ = _serve(cfg, params, traced=True)
    assert none == [] and recs
    assert plain == traced and len(plain) == 5
