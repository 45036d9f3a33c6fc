"""Port's recurrent families (rwkv6, ssm; hymba, hybrid) vs the JAX
reference on the CPU.

``repro.models.registry.init_params`` draws the REDUCED (fp32) weights;
every leaf goes through numpy to ``params_from_jax`` (norm weights,
token-shift mixes, dt biases and skip gains re-drawn from a seeded numpy
stream so they are not trivial), and the same tokens go to both sides.
``forward``, ``loss_fn``, ``decode_step`` and its caches must agree at the
reference suite's ``rtol = atol = 1e-4`` (the state, whose entries reach
~1e2, at ``rtol = 1e-4, atol = 1e-3``: fp32 sums of another order);
decode must reproduce the teacher-forced logits within the reference's own
bound ``err / scale < 2e-2`` (tests/test_models.py); ``generate``'s token
streams must equal ``repro.launch.serve.generate``'s at the sizes of
tests/test_system.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.hopper import dispatch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import hybrid, registry, ssm, transformer  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-4, atol=1e-3)
ARCHS = ("rwkv6-3b", "hymba-1.5b")
RETOUCH = ("norm", "mu_", "ln_x", "dt_bias", "ssm_D")


def _np_params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jregistry.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, leaf in list(tree["layers"].items()):
        if any(tag in name for tag in RETOUCH):
            base = 0.5 if name.startswith("mu_") else (0.0 if name == "dt_bias" else 1.0)
            tree["layers"][name] = (base + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    tree["final_norm"] = (1.0 + 0.1 * rng.standard_normal(tree["final_norm"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_get_config(request.param, reduced=True)
    tcfg = get_config(request.param, reduced=True)
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = ssm.params_from_jax(np_params, device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch, reduced):
    assert dataclasses.asdict(get_config(arch, reduced)) == dataclasses.asdict(
        jax_get_config(arch, reduced))


@pytest.mark.parametrize("reduced", [False, True])
def test_global_layer_mask_matches_reference(reduced):
    cfg = get_config("hymba-1.5b", reduced)
    want = np.asarray(jhybrid.global_layer_mask(jax_get_config("hymba-1.5b", reduced)))
    np.testing.assert_array_equal(hybrid.global_layer_mask(cfg), want)
    if not reduced:  # 15.5 rounds half to even: layers 0, 16, 31
        assert hybrid.global_layer_mask(cfg).nonzero()[0].tolist() == [0, 16, 31]


def test_init_params_shapes_match_reference(model):
    jcfg, tcfg, jp, _ = model
    mine = registry.init_params(tcfg, seed=1, device="cpu")

    def sig(tree):
        return {k: sig(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tree.items()}

    assert sig(mine) == jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)


def test_forward_logits_match_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(tcfg, (2, 37))
    want, _ = jregistry.forward(jp, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, aux = registry.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape and aux == 0.0
    _close(got, want)


def test_loss_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 21))
    labels = rng.integers(-1, tcfg.vocab_size, (2, 21))  # some ignored
    want = jregistry.loss_fn(jp, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                                        "labels": jnp.asarray(labels, jnp.int32)})
    got = registry.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens),
                                      "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


def test_decode_and_cache_match_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(tcfg, (2, 9))
    jc = jregistry.init_cache(jcfg, 2, 12)
    tc = registry.init_cache(tcfg, 2, 12, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tc.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    for t in range(tokens.shape[1]):
        batch = {"token": tokens[:, t], "position": np.full((2,), t, np.int32)}
        jl, jc = jregistry.decode_step(jp, jcfg, jc, jax.tree.map(jnp.asarray, batch))
        tl, tc = registry.decode_step(tp, tcfg, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert tl.dtype == torch.float32
        _close(tl, jl)
    for name in jc:
        _close(tc[name], jc[name], STATE_TOL if name == "ssm_state" else TOL)


def test_decode_matches_forward(model):
    """Incremental decode reproduces teacher-forced logits (the reference's
    own bound, tests/test_models.py test_decode_matches_forward)."""
    _, tcfg, _, tp = model
    S = 10
    tokens = torch.from_numpy(_tokens(tcfg, (2, S)))
    full, _ = registry.forward(tp, tcfg, {"tokens": tokens})
    cache = registry.init_cache(tcfg, 2, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = registry.decode_step(
            tp, tcfg, cache, {"token": tokens[:, t], "position": torch.full((2,), t)})
        outs.append(lg)
    err = float((torch.stack(outs, 1) - full.float()).abs().max())
    assert err / float(full.abs().max()) < 2e-2


def test_generate_streams_equal_reference(model):
    """tests/test_system.py test_generate_ssm_and_hybrid's sizes."""
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(tcfg, (2, 6))
    want = np.asarray(jserve.generate(jcfg, jp, jnp.asarray(tokens, jnp.int32),
                                      gen_len=4, max_len=12))
    got = serve.generate(tcfg, tp, torch.from_numpy(tokens), 4, 12)
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_prefill_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = _tokens(tcfg, (2, 7), seed=3)
    jlog, jc = jserve.scan_prefill(jp, jcfg, jregistry.init_cache(jcfg, 2, 8),
                                   jnp.asarray(tokens, jnp.int32))
    tlog, tc = serve.scan_prefill(tp, tcfg, registry.init_cache(tcfg, 2, 8, device="cpu"),
                                  torch.from_numpy(tokens))
    _close(tlog, jlog)
    _close(tc["ssm_state"], jc["ssm_state"], STATE_TOL)


def test_forward_launches_no_kernel_on_the_cpu(model):
    _, tcfg, _, tp = model
    dispatch.reset_launches()
    registry.forward(tp, tcfg, {"tokens": torch.from_numpy(_tokens(tcfg, (1, 5)))})
    assert not dispatch.LAUNCHES


def test_time_mix_state_handoff_matches_reference():
    """A sequence split in two, the second half from the first's state,
    gives the whole sequence's output and state (rwkv6 time-mix)."""
    jcfg = jax_get_config("rwkv6-3b", reduced=True)
    tcfg = get_config("rwkv6-3b", reduced=True)
    np_params = _np_params(jcfg)
    lp = {k: torch.from_numpy(np.array(v[0])) for k, v in np_params["layers"].items()}
    jlp = {k: jnp.asarray(v[0]) for k, v in np_params["layers"].items()}
    x = np.random.default_rng(2).standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    prev = ssm._shift(tx)
    whole, S = ssm.time_mix(lp, tcfg, tx, prev)
    from repro.models import ssm as jssm
    jwhole, jS = jssm.time_mix(jlp, jcfg, jnp.asarray(x), jssm._shift(jnp.asarray(x)))
    _close(whole, jwhole)
    _close(S, jS, STATE_TOL)
    first, S1 = ssm.time_mix(lp, tcfg, tx[:, :9], prev[:, :9])
    second, S2 = ssm.time_mix(lp, tcfg, tx[:, 9:], prev[:, 9:], state=S1)
    torch.testing.assert_close(torch.cat([first, second], 1), whole, **TOL)
    torch.testing.assert_close(S2, S, **STATE_TOL)


def test_attention_decode_matches_reference():
    """The contiguous-cache decode attention hymba's decode step calls."""
    jcfg = jax_get_config("hymba-1.5b", reduced=True)
    tcfg = get_config("hymba-1.5b", reduced=True)
    np_params = _np_params(jcfg)
    lp = {k: torch.from_numpy(np.array(v[1])) for k, v in np_params["layers"].items()}
    jlp = {k: jnp.asarray(v[1]) for k, v in np_params["layers"].items()}
    rng = np.random.default_rng(4)
    K, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim()
    x = rng.standard_normal((3, tcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((3, K, 16, hd)).astype(np.float32)
    vc = rng.standard_normal((3, K, 16, hd)).astype(np.float32)
    pos = np.array([3, 9, 15], np.int32)
    cos, sin = TL.rope_cos_sin(torch.from_numpy(pos), hd, tcfg.rope_theta)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), hd, jcfg.rope_theta)
    for window in (0, tcfg.sliding_window):
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        o, tk, tv = transformer.attention_decode(lp, tcfg, torch.from_numpy(x), cos, sin, tk, tv,
                                                 torch.from_numpy(pos), window=window)
        jo, jk, jv = jtransformer.attention_decode(jlp, jcfg, jnp.asarray(x), jcos, jsin,
                                                   jnp.asarray(kc), jnp.asarray(vc),
                                                   jnp.asarray(pos), window=window)
        _close(o, jo)
        _close(tk, jk)
        _close(tv, jv)


def test_cross_entropy_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 256)).astype(np.float32)
    labels = rng.integers(-1, 200, (2, 7))
    want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), 200)
    got = TL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), 200)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    none = TL.cross_entropy_loss(torch.from_numpy(logits), torch.full((2, 7), -1), 200)
    assert float(none) == 0.0


def test_registry_covers_the_ported_families():
    dense = get_config("occamy-gptj", reduced=True)
    params = registry.init_params(dense, device="cpu")
    tokens = torch.from_numpy(_tokens(dense, (1, 6)))
    got, _ = registry.forward(params, dense, {"tokens": tokens})
    want, _ = transformer.forward(params, dense, {"tokens": tokens})
    assert torch.equal(got, want)
    loss = registry.loss_fn(params, dense, {"tokens": tokens, "labels": tokens})
    assert float(loss) > 0
    cache = registry.init_cache(dense, 1, 8, device="cpu")
    step = {"token": tokens[:, 0], "position": torch.zeros(1, dtype=torch.int32)}
    got, _ = registry.decode_step(params, dense, {k: v.clone() for k, v in cache.items()}, step)
    want, _ = transformer.decode_step(params, dense, cache, step)
    assert torch.equal(got, want)
    assert tuple(serve.generate(dense, params, tokens, 2, 8).shape) == (1, 8)
    for arch in ("phi3.5-moe-42b-a6.6b", "pixtral-12b", "whisper-large-v3"):
        cfg = get_config(arch, reduced=True)
        assert set(registry.init_params(cfg, device="cpu")) >= {"embed", "layers", "final_norm"}
    with pytest.raises(NotImplementedError, match="not one the port knows"):
        registry.init_params(dense.replace(family="diffusion"), device="cpu")


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.init_params(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "rwkv6-3b", "--reduced"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 8)" in out and "on cpu" in out
