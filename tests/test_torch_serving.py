"""Port serving stack vs the JAX reference on the CPU.

- The port's scheduler and ``repro.serving.scheduler`` step through the same
  random walk of atomic actions and stay in the same canonical state.
- The port's ``ServingEngine`` + ``StubModel`` on ``bench_serve``'s seed-0
  workload reproduces the committed admission-trace hash
  (``BENCH_serve.json``): the trace is scheduler arithmetic only.
- The port's engine and the JAX engine, on REDUCED ``occamy-gptj`` with the
  same carried-over weights and requests, give identical token streams,
  with and without preemption, with full-precision and with fp8 KV pools;
  preempt/resume round-trips bitwise.
- With no CUDA and no ``device=``, the engine raises instead of moving to
  the CPU.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks.bench_serve import poisson_requests  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.paged_cache import init_paged_cache  # noqa: E402

BENCH_SERVE_TRACE_SHA256 = "6f362960a2e5b44261bc80c01d5c2a0d6aa65571f14326bf6dfcf8107b8919a7"


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_random_walk_matches_reference(seed):
    rng = np.random.default_rng(seed)
    templates = {
        rid: dict(prompt=tuple(int(x) for x in rng.integers(1, 50, int(rng.integers(1, 7)))),
                  max_new_tokens=int(rng.integers(1, 7)),
                  priority=int(rng.integers(0, 2)))
        for rid in range(10)
    }
    mods = (jsched, tsched)
    scheds = [m.ContinuousBatchingScheduler(num_blocks=7, block_size=2, max_slots=3)
              for m in mods]
    reqs = [{rid: m.Request(rid=rid, **t) for rid, t in templates.items()} for m in mods]
    unsubmitted = list(templates)
    for step in range(300):
        choices = [("admit",)] + [("decode", s) for s in sorted(scheds[0].running)]
        if unsubmitted:
            choices.append(("submit", unsubmitted[0]))
        action = choices[int(rng.integers(len(choices)))]
        if action[0] == "submit":
            unsubmitted.pop(0)
        outs = [m.apply_action(s, action, step, requests=r)
                for m, s, r in zip(mods, scheds, reqs)]
        assert outs[0] == outs[1], (step, action)
        assert jsched.canonical_state(scheds[0]) == tsched.canonical_state(scheds[1])
    assert scheds[0].events == scheds[1].events
    assert scheds[1].leaked_blocks() == 0


def test_stub_engine_reproduces_bench_serve_trace():
    # bench_serve defaults: gemma-2b REDUCED vocab, 24 requests at 1.5/step,
    # 12 blocks x 8 rows, 4 slots, 6 blocks per sequence, no EOS
    reqs = poisson_requests(np.random.default_rng(0), n=24, lam=1.5, vocab=512)
    eng = teng.ServingEngine(teng.StubModel(), num_blocks=12, block_size=8,
                             max_slots=4, max_blocks_per_seq=6, eos_id=None)
    for r in reqs:
        eng.submit(teng.Request(**dataclasses.asdict(r)))
    out = eng.run(max_steps=5000)
    trace = hashlib.sha256(repr(eng.scheduler.admission_trace()).encode()).hexdigest()
    assert len(out) == 24 and eng.step_count == 79
    assert sum(len(v) for v in out.values()) == 266
    assert sum(1 for e in eng.scheduler.events if e[0] == "preempt") == 9
    assert eng.leaked_blocks() == 0
    assert trace == BENCH_SERVE_TRACE_SHA256


@pytest.fixture(scope="module")
def gptj():
    jcfg = jax_get_config("occamy-gptj", reduced=True)
    cfg = get_config("occamy-gptj", reduced=True)
    np_params = jax.tree.map(np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, np_params, ttr.params_from_jax(np_params, device="cpu")


def _requests(mod):
    rng = np.random.default_rng(7)
    return [mod.Request(rid=rid,
                        prompt=tuple(int(x) for x in rng.integers(1, 512, int(rng.integers(3, 8)))),
                        max_new_tokens=6, arrival=rid // 2)
            for rid in range(5)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    out = eng.run(max_steps=500)
    assert eng.leaked_blocks() == 0
    return out, sum(1 for e in eng.scheduler.events if e[0] == "preempt")


GEOMETRY = dict(block_size=4, max_slots=3, max_blocks_per_seq=4)


@pytest.mark.parametrize("num_blocks", [7, 40], ids=["tight", "roomy"])
def test_engine_token_streams_match_jax_engine(gptj, num_blocks):
    jcfg, cfg, np_params, params = gptj
    want, jpre = _serve(jeng.ServingEngine.with_model(
        jcfg, jax.tree.map(jax.numpy.asarray, np_params), num_blocks=num_blocks, **GEOMETRY),
        _requests(jeng))
    got, tpre = _serve(teng.ServingEngine.with_model(
        cfg, params, num_blocks=num_blocks, device="cpu", **GEOMETRY), _requests(teng))
    assert (tpre > 0) == (num_blocks == 7) and tpre == jpre
    assert got == want


def test_engine_preempt_resume_is_bitwise(gptj):
    _, cfg, _, params = gptj
    tight, pre = _serve(teng.ServingEngine.with_model(
        cfg, params, num_blocks=6, device="cpu", **GEOMETRY), _requests(teng))
    roomy, none = _serve(teng.ServingEngine.with_model(
        cfg, params, num_blocks=40, device="cpu", **GEOMETRY), _requests(teng))
    assert pre > 0 and none == 0
    assert tight == roomy


@pytest.mark.parametrize("num_blocks", [7, 40], ids=["tight", "roomy"])
def test_fp8_engine_token_streams_match_jax_engine(gptj, num_blocks):
    jcfg, cfg, np_params, params = gptj
    want, jpre = _serve(jeng.ServingEngine.with_model(
        jcfg, jax.tree.map(jax.numpy.asarray, np_params), num_blocks=num_blocks,
        precision="fp8", **GEOMETRY), _requests(jeng))
    eng = teng.ServingEngine.with_model(cfg, params, num_blocks=num_blocks, precision="fp8",
                                        device="cpu", **GEOMETRY)
    assert eng.model.cache.quantized and eng.model.cache.k_pool.dtype == torch.float8_e4m3fn
    got, tpre = _serve(eng, _requests(teng))
    assert (tpre > 0) == (num_blocks == 7) and tpre == jpre
    assert got == want


def test_fp8_engine_preempt_resume_is_bitwise(gptj):
    _, cfg, _, params = gptj
    tight, pre = _serve(teng.ServingEngine.with_model(
        cfg, params, num_blocks=6, precision="fp8", device="cpu", **GEOMETRY), _requests(teng))
    roomy, none = _serve(teng.ServingEngine.with_model(
        cfg, params, num_blocks=40, precision="fp8", device="cpu", **GEOMETRY), _requests(teng))
    assert pre > 0 and none == 0
    assert tight == roomy


def test_paged_cache_gather_is_a_host_copy(gptj):
    _, cfg, _, _ = gptj
    cache = init_paged_cache(cfg, num_blocks=6, block_size=2, device="cpu")
    cache.k_pool.normal_()
    cache.v_pool.normal_()
    payload = cache.gather_blocks([2, 4])
    before = {k: v.clone() for k, v in payload.items()}
    cache.k_pool.zero_()  # later steps overwrite the freed pages
    cache.v_pool.zero_()
    assert all(torch.equal(payload[k], before[k]) for k in payload)
    cache.restore_blocks([5, 1], payload)
    assert torch.equal(cache.k_pool[:, [5, 1]], before["k"])
    assert torch.equal(cache.v_pool[:, [5, 1]], before["v"])


def test_no_cpu_retreat_without_a_device(gptj):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _, cfg, _, params = gptj
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.ServingEngine.with_model(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(cfg, num_blocks=4, block_size=2)
