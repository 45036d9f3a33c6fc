"""Port MoE family (``models/moe.py`` through the transformer, ``generate``,
the paged engine and the train launcher) vs the JAX reference on the CPU.

phi3.5-moe-42b-a6.6b and grok-1-314b at REDUCED (fp32) size; the weights
are ``repro.models.transformer.init_params``'s, carried over through numpy
by ``params_from_jax`` (norm weights re-drawn from a seeded numpy stream so
they are not trivial), and the same numpy inputs go to both sides.

- ``moe_mlp`` at ``capacity_factor`` 1.0 (pairs are dropped: the port's
  slots show it) and 8.0 (none are), and ``moe_mlp_decode``, match the
  reference's outputs and aux loss at rtol = atol = 1e-4, and the rows
  whose every choice was dropped (all zero) coincide. A router with three
  equal columns makes exact top-k ties; the port picks the lower expert
  index, as ``jax.lax.top_k`` does.
- ``forward`` (logits and the summed aux), ``loss_fn`` and five
  ``decode_step``s from a ``prefill_step`` cache match the reference's:
  logits to 1e-4 of the reference's max|logits| (the reference's stacked
  init scales each leaf by 1/sqrt(num_layers), so REDUCED's two layers
  give attention scores of std ~5 and a few small logits carry the fp32
  rounding of near one-hot softmaxes past an elementwise 1e-4), the rest
  at rtol = atol = 1e-4; decode from an empty cache reproduces the teacher-forced forward
  within the reference's 2e-2 (tests/test_models.py, at capacity 8.0).
- ``generate``'s token streams equal ``repro.launch.serve.generate``'s.
- The paged engine on phi3.5-moe REDUCED gives the JAX engine's token
  streams with and without preemption, with full-precision and fp8 KV
  pools, leaking no block; its prefill runs on the block-padded bucket, as
  the reference's does, so capacity comes from the padded length.
- ``launch/train.py`` for 3 steps from the reference's initial state gives
  ``repro.runtime.train_loop.run_training``'s losses within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import moe, registry, transformer  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MOE = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")


def _np_params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jtr.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, leaf in list(tree["layers"].items()):
        if name.endswith("norm"):
            tree["layers"][name] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return tree


@pytest.fixture(scope="module", params=MOE)
def model(request):
    jcfg = jax_get_config(request.param, reduced=True)
    tcfg = get_config(request.param, reduced=True)
    np_params = _np_params(jcfg)
    return jcfg, tcfg, np_params, transformer.params_from_jax(np_params, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _close_logits(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _layer0(np_params):
    return {k: v[0] for k, v in np_params["layers"].items()}


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_mlp_matches_reference(model, cf):
    jcfg, tcfg, np_params, _ = model
    jcfg, tcfg = jcfg.replace(capacity_factor=cf), tcfg.replace(capacity_factor=cf)
    lp = _layer0(np_params)
    x = np.random.default_rng(3).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    want, waux = jmoe.moe_mlp(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg)
    tp = transformer.params_from_jax(lp, device="cpu")
    got, gaux = moe.moe_mlp(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    _close(gaux, waux)
    want = np.asarray(want)
    np.testing.assert_array_equal((got == 0).all(-1).numpy(), (want == 0).all(-1))
    _, topi, _ = moe._route(tp, torch.from_numpy(x), tcfg)
    _, slot, _ = moe._dispatch(torch.from_numpy(x), topi, tcfg.num_experts,
                               moe.capacity(tcfg, 24))
    dropped = int((slot == tcfg.num_experts * moe.capacity(tcfg, 24)).sum())
    assert (dropped > 0) == (cf == 1.0)


def test_moe_mlp_decode_matches_reference(model):
    jcfg, tcfg, np_params, _ = model
    lp = _layer0(np_params)
    x = np.random.default_rng(4).standard_normal((5, tcfg.d_model)).astype(np.float32)
    want, _ = jmoe.moe_mlp_decode(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg)
    got = moe.moe_mlp_decode(transformer.params_from_jax(lp, device="cpu"), torch.from_numpy(x), tcfg)
    _close(got, want)


def test_top_k_ties_break_to_the_lower_expert(model):
    jcfg, tcfg, np_params, _ = model
    lp = _layer0(np_params)
    router = lp["router"].copy()
    router[:, 2] = router[:, 0]  # three experts with one logit: exact ties
    router[:, 3] = router[:, 0]
    lp = dict(lp, router=router)
    x = np.random.default_rng(5).standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, lp), transformer.params_from_jax(lp, device="cpu")
    wv, wi, waux = jmoe._route(jp, jnp.asarray(x), jcfg)
    gv, gi, gaux = moe._route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert (gi.numpy() == 0).any() and (gi.numpy() == 2).any()
    _close(gv, wv)
    _close(gaux, waux)
    want, _ = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    got, _ = moe.moe_mlp(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    want, _ = jmoe.moe_mlp_decode(jp, jnp.asarray(x[:, 0]), jcfg)
    _close(moe.moe_mlp_decode(tp, torch.from_numpy(x[:, 0]), tcfg), want)


def test_init_params_shapes_match_reference(model):
    jcfg, tcfg, np_params, _ = model
    mine = transformer.init_params(tcfg, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), np_params)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), mine)
    assert got == want
    assert {"router", "moe_wi", "moe_wo", "moe_wg"} <= set(mine["layers"])
    assert mine["layers"]["router"].dtype == torch.float32


def test_forward_and_loss_match_reference(model):
    jcfg, tcfg, np_params, tp = model
    b = jregistry.make_batch(jcfg, JSHAPES["train_4k"], np.random.default_rng(2),
                             batch_override=2, seq_override=16)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    jp = jax.tree.map(jnp.asarray, np_params)
    want, waux = jregistry.forward(jp, jcfg, b)
    got, gaux = registry.forward(tp, tcfg, tb)
    _close_logits(got, want)
    _close(gaux, waux)
    assert float(gaux) > 0
    _close(registry.loss_fn(tp, tcfg, tb), jregistry.loss_fn(jp, jcfg, b))


def test_decode_step_matches_reference(model):
    jcfg, tcfg, np_params, tp = model
    jp = jax.tree.map(jnp.asarray, np_params)
    B, S0, steps, max_len = 2, 7, 5, 16
    tokens = _tokens(tcfg, (B, S0 + steps))
    _, jcache = jtr.prefill_step(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :S0])}, max_len)
    _, tcache = transformer.prefill_step(tp, tcfg, {"tokens": torch.from_numpy(tokens[:, :S0])},
                                         max_len)
    _close(tcache["k"], jcache["k"])
    for i in range(steps):
        pos = np.full((B,), S0 + i, np.int32)
        want, jcache = jregistry.decode_step(jp, jcfg, jcache, {
            "token": jnp.asarray(tokens[:, S0 + i]), "position": jnp.asarray(pos)})
        got, tcache = registry.decode_step(tp, tcfg, tcache, {
            "token": torch.from_numpy(tokens[:, S0 + i]), "position": torch.from_numpy(pos)})
        assert got.dtype == torch.float32
        _close_logits(got, want)
    _close(tcache["v"], jcache["v"])


def test_decode_matches_forward(model):
    """The reference's test_decode_matches_forward on the port: at capacity
    8.0 nothing is dropped, and decode from an empty cache reproduces the
    teacher-forced logits within 2e-2 of max|logits|."""
    _, tcfg, _, tp = model
    cfg = tcfg.replace(capacity_factor=8.0)
    S = 10
    b = registry.make_batch(cfg, SHAPES["prefill_32k"], batch_override=2, seq_override=S,
                            device="cpu")
    full, _ = registry.forward(tp, cfg, b)
    cache = registry.init_cache(cfg, 2, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = registry.decode_step(tp, cfg, cache, {
            "token": b["tokens"][:, t], "position": torch.full((2,), t, dtype=torch.int32)})
        outs.append(lg)
    err = float((torch.stack(outs, 1) - full.float()).abs().max())
    assert err / float(full.abs().max()) < 2e-2


def test_generate_token_streams_equal_reference(model):
    jcfg, tcfg, np_params, tp = model
    tokens = _tokens(tcfg, (3, 9), seed=5)
    want = jserve.generate(jcfg, jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), 6, 16)
    got = serve.generate(tcfg, tp, torch.from_numpy(tokens), 6, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the paged engine on phi3.5-moe REDUCED ---------------------------------


@pytest.fixture(scope="module")
def phi():
    jcfg = jax_get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    cfg = get_config("phi3.5-moe-42b-a6.6b", reduced=True)
    np_params = _np_params(jcfg)
    return jcfg, cfg, np_params, transformer.params_from_jax(np_params, device="cpu")


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


@pytest.mark.parametrize("precision", [None, "fp8"], ids=["full", "fp8"])
@pytest.mark.parametrize("num_blocks", [7, 40], ids=["tight", "roomy"])
def test_engine_token_streams_match_jax_engine(phi, num_blocks, precision):
    jcfg, cfg, np_params, params = phi
    want, jpre = _serve(jeng.ServingEngine.with_model(
        jcfg, jax.tree.map(jnp.asarray, np_params), num_blocks=num_blocks, precision=precision,
        **GEOMETRY), _requests(jeng))
    eng = teng.ServingEngine.with_model(cfg, params, num_blocks=num_blocks, precision=precision,
                                        device="cpu", **GEOMETRY)
    assert eng.model.cache.quantized == (precision == "fp8")
    got, tpre = _serve(eng, _requests(teng))
    assert (tpre > 0) == (num_blocks == 7) and tpre == jpre
    assert got == want


def test_engine_prefills_the_padded_bucket(phi, monkeypatch):
    """The MoE prefill sees the prompt padded to its block bucket, so
    capacity comes from the padded length (the reference's behaviour)."""
    _, cfg, _, params = phi
    seen = []
    real = moe.capacity
    monkeypatch.setattr(moe, "capacity", lambda c, s: seen.append(s) or real(c, s))
    eng = teng.ServingEngine.with_model(cfg, params, num_blocks=40, device="cpu", **GEOMETRY)
    eng.submit(teng.Request(rid=0, prompt=(5, 6, 7, 8, 9), max_new_tokens=2))
    eng.run(max_steps=50)
    assert seen and set(seen) == {8}  # 5 tokens in a bucket of 2 blocks of 4


# --- training ---------------------------------------------------------------


def test_launch_train_matches_reference_run_training(monkeypatch, capsys):
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg = jax_get_config(arch, reduced=True)
    kw = dict(num_steps=3, seed=0, batch_override=2, seq_override=16, log_every=100,
              log_fn=lambda *a: None)
    _, jlosses, _ = jtrain_loop.run_training(jcfg, JSHAPES["train_4k"], **kw)
    np_init = jax.tree.map(np.asarray, jtrain_loop.init_train_state(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(train_loop, "init_train_state", lambda cfg, seed, device=None:
                        train_loop.state_from_jax(np_init, device=device))
    state, losses, _ = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                                   "--batch", "2", "--seq", "16", "--log-every", "1"])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    assert int(state["opt"]["step"]) == 3
    assert "done: 3 steps" in capsys.readouterr().out
