"""Port dense decode, ``generate``, ``make_batch`` and the serving twins vs
the JAX reference on the CPU.

For the five dense configs (occamy-gptj, gemma-2b, qwen1.5-4b, qwen3-14b,
command-r-35b) at REDUCED (fp32) size, ``repro.models.transformer.
init_params`` draws the weights; every leaf goes through numpy to
``params_from_jax`` (norm weights and biases re-drawn from a seeded numpy
stream so they are not trivial), and the same tokens go to both sides.

- ``CONFIG`` and ``REDUCED`` are field-equal to the reference's, and
  ``cache_spec`` gives the reference's shapes and dtypes.
- ``decode_step`` from a ``prefill_step`` cache, over 5 steps, matches the
  reference's logits and caches at the reference suite's
  ``rtol = atol = 1e-4``. The port writes the cache in place, so each side
  gets its own copy.
- Decode reproduces the teacher-forced ``forward`` within the reference's
  own bound, ``err / max|logits| < 2e-2`` (tests/test_models.py).
- Paged decode equals contiguous decode bitwise at a pinned ``bs``, the
  port's twin of tests/test_paged_decode.py:201.
- ``generate``'s token streams equal ``repro.launch.serve.generate``'s.
- ``registry.make_batch`` is bitwise the reference's for one seed.
- ``launch/serve_bench.py`` at its defaults reproduces ``BENCH_serve.json``
  (trace hash, 24/24, 266 tokens, 79 steps, 9 preemptions), and with the
  reference's weights its token streams equal the JAX engine's;
  ``prefill_rate`` and ``serve_llm`` run once.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_serve import poisson_requests as jax_poisson_requests  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.hopper import dispatch  # noqa: E402
from repro_torch.launch import bench_rows, prefill_rate, serve, serve_bench, serve_llm  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.serving.paged_cache import init_paged_cache  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ("occamy-gptj", "gemma-2b", "qwen1.5-4b", "qwen3-14b", "command-r-35b")
BENCH_SERVE = Path(__file__).resolve().parents[1] / "BENCH_serve.json"


def _np_params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jtr.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, leaf in list(tree["layers"].items()):
        if name.endswith("norm") or name in ("bq", "bk", "bv"):
            tree["layers"][name] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    tree["final_norm"] = (1.0 + 0.1 * rng.standard_normal(tree["final_norm"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    jcfg = jax_get_config(request.param, reduced=True)
    tcfg = get_config(request.param, reduced=True)
    np_params = _np_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_params), transformer.params_from_jax(
        np_params, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_reference(arch, reduced):
    assert dataclasses.asdict(get_config(arch, reduced)) == dataclasses.asdict(
        jax_get_config(arch, reduced))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_cache_spec_equals_reference(arch, reduced):
    want = jtr.cache_spec(jax_get_config(arch, reduced), 3, 40)
    got = registry.cache_spec(get_config(arch, reduced), 3, 40)
    assert {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in got.items()} == {
        k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}


def test_init_cache_is_zeros_of_the_spec(model):
    _, tcfg, _, _ = model
    cache = registry.init_cache(tcfg, 2, 9, device="cpu")
    for name, (shape, dt) in registry.cache_spec(tcfg, 2, 9).items():
        assert tuple(cache[name].shape) == shape and cache[name].dtype == dt
        assert not cache[name].any()


def test_decode_step_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    B, S0, steps, max_len = 2, 7, 5, 16
    tokens = _tokens(tcfg, (B, S0 + steps))
    _, jcache = jtr.prefill_step(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :S0])}, max_len)
    _, tcache = transformer.prefill_step(tp, tcfg, {"tokens": torch.from_numpy(tokens[:, :S0])},
                                         max_len)
    _close(tcache["k"], jcache["k"])
    for i in range(steps):
        pos = np.full((B,), S0 + i, np.int32)
        want, jcache = jtr.decode_step(jp, jcfg, jcache, {"token": jnp.asarray(tokens[:, S0 + i]),
                                                          "position": jnp.asarray(pos)})
        got, tcache = registry.decode_step(tp, tcfg, tcache, {"token": torch.from_numpy(tokens[:, S0 + i]),
                                                              "position": torch.from_numpy(pos)})
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got, want)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_decode_step_writes_the_cache_in_place(model):
    _, tcfg, _, tp = model
    cache = registry.init_cache(tcfg, 2, 6, device="cpu")
    before = cache["k"].clone()
    batch = {"token": torch.tensor([3, 4]), "position": torch.tensor([0, 2])}
    _, out = registry.decode_step(tp, tcfg, cache, batch)
    assert out is cache
    changed = (cache["k"] != before).any(dim=(0, 2, 4))  # (B, S)
    assert changed.nonzero().tolist() == [[0, 0], [1, 2]]


def test_decode_matches_teacher_forced_forward(model):
    """The reference's bound (tests/test_models.py): decode from an empty
    cache reproduces the forward's logits within 2e-2 of max|logits|."""
    _, tcfg, _, tp = model
    S = 10
    b = registry.make_batch(tcfg, SHAPES["prefill_32k"], batch_override=2, seq_override=S,
                            device="cpu")
    full, _ = registry.forward(tp, tcfg, b)
    cache = registry.init_cache(tcfg, 2, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = registry.decode_step(tp, tcfg, cache, {
            "token": b["tokens"][:, t], "position": torch.full((2,), t, dtype=torch.int32)})
        outs.append(lg)
    err = float((torch.stack(outs, 1) - full.float()).abs().max())
    assert err / float(full.abs().max()) < 2e-2


def test_paged_decode_bitwise_vs_contiguous(model):
    """tests/test_paged_decode.py:201's claim for the port: the prefill's
    cache copied into shuffled pages, one paged and one contiguous step
    (the contiguous scan pinned to the page extent) give equal logits."""
    _, tcfg, _, tp = model
    rng = np.random.default_rng(3)
    B, S0, bs, nb = 2, 8, 4, 4
    tokens = torch.from_numpy(rng.integers(1, tcfg.vocab_size, (B, S0)).astype(np.int32))
    _, cache = transformer.prefill_step(tp, tcfg, {"tokens": tokens}, nb * bs)
    paged = init_paged_cache(tcfg, num_blocks=B * nb + 1, block_size=bs, device="cpu")
    perm = rng.permutation(B * nb) + 1
    table = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(nb):
            phys = int(perm[b * nb + j])
            table[b, j] = phys
            paged.k_pool[:, phys] = cache["k"][:, b, :, j * bs:(j + 1) * bs]
            paged.v_pool[:, phys] = cache["v"][:, b, :, j * bs:(j + 1) * bs]
    tok = torch.from_numpy(rng.integers(1, tcfg.vocab_size, B).astype(np.int32))
    posn = torch.full((B,), S0, dtype=torch.int32)
    with dispatch.block_override("decode_attention", bs=bs):
        want, cache = transformer.decode_step(tp, tcfg, cache, {"token": tok, "position": posn})
    pool_before = paged.k_pool.clone()
    got, paged = transformer.decode_step_paged(
        tp, tcfg, paged, {"token": tok, "position": posn, "block_table": torch.from_numpy(table)})
    assert torch.equal(got, want)
    assert not torch.equal(paged.k_pool, pool_before)  # the step wrote its row into a page
    for b in range(B):  # ... the contiguous step's row, in the page that holds S0
        page = table[b, S0 // bs]
        assert torch.equal(paged.k_pool[:, page, :, S0 % bs], cache["k"][:, b, :, S0])


def test_generate_token_streams_equal_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(tcfg, (3, 9), seed=5)
    want = jserve.generate(jcfg, jp, jnp.asarray(tokens), 6, 16)
    got = serve.generate(tcfg, tp, torch.from_numpy(tokens), 6, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["occamy-gptj", "rwkv6-3b", "hymba-1.5b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_make_batch_is_the_reference_batch(arch, shape):
    cfg, jcfg = get_config(arch, True), jax_get_config(arch, True)
    kw = dict(batch_override=3, seq_override=24)
    want = jregistry.make_batch(jcfg, JSHAPES[shape], np.random.default_rng(11), **kw)
    got = registry.make_batch(cfg, SHAPES[shape], np.random.default_rng(11), device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_registry_raises_for_the_families_not_ported():
    # every family of the reference is ported; a family the port does not
    # know raises at each entry point instead of reaching a wrong module
    cfg = get_config("gemma-2b", reduced=True).replace(family="diffusion")
    for call in (lambda: registry.cache_spec(cfg, 1, 4),
                 lambda: registry.make_batch(cfg, SHAPES["decode_32k"], device="cpu"),
                 lambda: registry.init_params(cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="not one the port knows"):
            call()
    with pytest.raises(NotImplementedError, match="families"):
        serve.generate(cfg, {}, torch.zeros((1, 2), dtype=torch.int32), 2, 4)
    with pytest.raises(NotImplementedError, match="transformer serves"):
        transformer.decode_step({}, cfg.replace(family="ssm"), {}, {})


def _bench_args(**kw):
    return serve_bench.parser().parse_args(
        ["--device", "cpu"] + [a for k, v in kw.items() for a in (f"--{k}", str(v))])


def test_serve_bench_reproduces_the_pinned_trace(tmp_path, capsys):
    pinned = {r["name"]: r for r in json.loads(BENCH_SERVE.read_text())["rows"]}
    out = tmp_path / "serve.json"
    assert serve_bench.main(["--device", "cpu", "--smoke", "--json", str(out)]) == 0
    assert "smoke OK" in capsys.readouterr().out
    rows = {r["name"]: r for r in json.loads(out.read_text())["rows"]}
    assert json.loads(out.read_text())["backend"] == "cpu"
    assert sorted(rows) == sorted(pinned)
    for name, keys in (("serve/throughput", ("arch", "completed", "requests", "seed", "steps",
                                             "tokens")),
                       ("serve/latency", ("block_size", "leaked_blocks", "num_blocks", "p50_steps",
                                          "p99_steps", "preemptions", "slots", "trace_sha256"))):
        assert sorted(rows[name]) == sorted(pinned[name])
        assert {k: rows[name][k] for k in keys} == {k: pinned[name][k] for k in keys}
    lat = rows["serve/latency"]
    assert lat["trace_sha256"] == "6f362960a2e5b44261bc80c01d5c2a0d6aa65571f14326bf6dfcf8107b8919a7"
    assert (rows["serve/throughput"]["completed"], rows["serve/throughput"]["tokens"],
            rows["serve/throughput"]["steps"], lat["preemptions"]) == (24, 266, 79, 9)


def test_serve_bench_token_streams_equal_the_jax_engine():
    args = _bench_args()
    jcfg = jax_get_config(args.arch, reduced=True)
    np_params = jax.tree.map(np.asarray, jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    got = serve_bench.run(args, bench_rows.Rows("cpu"),
                          params=transformer.params_from_jax(np_params, device="cpu"))
    engine = jeng.ServingEngine.with_model(
        jcfg, jax.tree.map(jnp.asarray, np_params), num_blocks=args.num_blocks,
        block_size=args.block_size, max_slots=args.slots,
        max_blocks_per_seq=args.max_blocks_per_seq, eos_id=None)
    reqs = jax_poisson_requests(np.random.default_rng(args.seed), n=args.requests, lam=args.rate,
                                vocab=jcfg.vocab_size)
    mine = serve_bench.poisson_requests(np.random.default_rng(args.seed), n=args.requests,
                                        lam=args.rate, vocab=jcfg.vocab_size)
    assert [dataclasses.astuple(r) for r in mine] == [dataclasses.astuple(r) for r in reqs]
    for r in reqs:
        engine.submit(r)
    want = engine.run(max_steps=args.max_steps)
    assert len(want) == 24 and got["completed"] == want
    assert got["steps"] == engine.step_count and got["leaked"] == 0


def test_serve_bench_smoke_reports_violations():
    args = _bench_args(requests=3)
    ok = dict(completed={0: (1,), 1: (2,), 2: (3,)}, leaked=0, p99=4.0)
    assert serve_bench.smoke_check(args, ok) == []
    bad = dict(completed={0: (1,)}, leaked=2, p99=float("nan"))
    assert len(serve_bench.smoke_check(args, bad)) == 3


def test_prefill_rate_runs_on_the_cpu(tmp_path):
    rows = bench_rows.Rows("cpu")
    prefill_rate.run(rows, device="cpu", seqs=(16, 32))
    assert [r[0] for r in rows.rows] == ["fig12_gptj_prefill_s16", "fig12_gptj_prefill_s32"]
    assert all(r[1] > 0 and r[2].endswith("tok/s") for r in rows.rows)
    rows.emit_json(tmp_path / "rows.json")
    assert json.loads((tmp_path / "rows.json").read_text())["backend"] == "cpu"


def test_serve_llm_runs_on_the_cpu(capsys):
    engine = serve_llm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch   4: prefill 64 + decode 32" in out and "(shape (16, 96))" in out
    assert "engine: 12/12 requests" in out and engine.leaked_blocks() == 0
    assert sum(1 for e in engine.scheduler.events if e[0] == "preempt") > 0


def test_serve_main_runs_dense_on_the_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.startswith("occamy-gptj-reduced on cpu: generated (2, 8)")
    assert "prefilled in one pass" in out


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: serve.main(["--reduced"]),
                 lambda: serve_bench.main([]),
                 lambda: prefill_rate.main([]),
                 lambda: serve_llm.main([]),
                 lambda: registry.make_batch(get_config("gemma-2b", True), SHAPES["decode_32k"]),
                 lambda: registry.init_cache(get_config("gemma-2b", True), 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
