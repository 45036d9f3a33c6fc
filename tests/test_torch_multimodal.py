"""Port vlm (pixtral-12b) and audio (whisper-large-v3) families vs the JAX
reference on the CPU, and the entry points that take every new family.

REDUCED (fp32) configs; the weights are ``repro.models.registry.
init_params``'s, carried over through numpy by ``params_from_jax`` (the
nested ``connector`` and ``enc_layers`` included), and the same numpy
inputs go to both sides.

- ``CONFIG``/``REDUCED`` of all four new configs are field-equal to the
  reference's; pixtral's and whisper's ``init_params`` give the
  reference's leaves, shapes and dtypes, ``cache_spec`` and
  ``input_specs`` the reference's shapes and dtypes.
- ``forward``, ``loss_fn`` and ``decode_step`` match the reference's:
  pixtral's logits and caches to 1e-4 of their max| |, the rest at
  rtol = atol = 1e-4. whisper's logits and caches (``build_cross_cache``'s
  too) to 5e-4 of their max| |: the reference's stacked
  init (each leaf scaled by 1/sqrt(num_layers)) gives attention scores of
  std ~5, and on its 16 non-causal frames the near one-hot softmaxes
  carry fp32 rounding that puts both sides ~5e-4 of max|logits| from an
  fp64 evaluation of the same model; ``encode`` itself stays within
  rtol = atol = 1e-4.
- The reference's ``test_decode_matches_forward`` (whisper) and
  ``test_vlm_prefill_then_decode`` (pixtral) rebuilt on the port, at 2e-2.
- ``make_batch`` (train, prefill, decode) and ``batch_at_step`` are bitwise
  the reference's for one seed, for vlm, audio and MoE.
- ``generate``'s token streams equal ``repro.launch.serve.generate``'s
  with the same ``extra_batch``; ``launch.serve.main`` runs every new
  family REDUCED on the CPU.
- ``launch/train.py`` on whisper for 3 steps from the reference's initial
  state gives ``run_training``'s losses within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import multimodal as jmm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import multimodal, registry, transformer  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("pixtral-12b", "whisper-large-v3")
NEW = ("phi3.5-moe-42b-a6.6b", "grok-1-314b") + FAMILIES
LOGIT_REL = {"vlm": 1e-4, "audio": 5e-4}


def _np_params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jregistry.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for group in ("layers", "enc_layers"):
        for name, leaf in list(tree.get(group, {}).items()):
            if name.endswith("norm"):
                tree[group][name] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return tree


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    jcfg = jax_get_config(request.param, reduced=True)
    tcfg = get_config(request.param, reduced=True)
    np_params = _np_params(jcfg)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, np_params),
            transformer.params_from_jax(np_params, device="cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _close_scaled(cfg, got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= LOGIT_REL[cfg.family] * np.abs(want).max(), (err, np.abs(want).max())


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _extra(cfg, B, seed=9):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    return {"frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_reference(arch, reduced):
    assert dataclasses.asdict(get_config(arch, reduced)) == dataclasses.asdict(
        jax_get_config(arch, reduced))


def test_init_params_and_specs_match_reference(model):
    jcfg, tcfg, jp, _ = model
    mine = registry.init_params(tcfg, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), mine)
    assert got == want
    for name, spec in jregistry.cache_spec(jcfg, 3, 11).items():
        shape, dt = registry.cache_spec(tcfg, 3, 11)[name]
        assert shape == spec.shape and dt == getattr(torch, str(spec.dtype))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        ref = jregistry.input_specs(jcfg, JSHAPES[shape])
        specs = registry.input_specs(tcfg, SHAPES[shape])
        assert {k: (s.shape, str(s.dtype)) for k, s in ref.items()} == {
            k: (sh, str(dt).replace("torch.", "")) for k, (sh, dt) in specs.items()}


def test_forward_and_loss_match_reference(model):
    jcfg, tcfg, jp, tp = model
    b = jregistry.make_batch(jcfg, JSHAPES["train_4k"], np.random.default_rng(2),
                             batch_override=2, seq_override=12)
    want, _ = jregistry.forward(jp, jcfg, b)
    got, aux = registry.forward(tp, tcfg, _torch_batch(b))
    assert tuple(got.shape) == want.shape and aux == 0.0
    _close_scaled(tcfg, got, want)
    _close(registry.loss_fn(tp, tcfg, _torch_batch(b)), jregistry.loss_fn(jp, jcfg, b))


def test_decode_step_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    B, S0, steps, max_len = 2, 6, 5, 16
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S0 + steps)).astype(np.int32)
    extra = _extra(tcfg, B)
    if tcfg.family == "vlm":
        batch = {"tokens": tokens[:, :S0], **extra}
        _, jcache = jtr.prefill_step(jp, jcfg, jax.tree.map(jnp.asarray, batch), max_len)
        _, tcache = transformer.prefill_step(tp, tcfg, _torch_batch(batch), max_len)
        pos0 = S0 + tcfg.num_patches
        _close(tcache["k"], jcache["k"])
    else:
        jcache = jregistry.init_cache(jcfg, B, max_len)
        jcache["cross_k"], jcache["cross_v"] = jmm.build_cross_cache(jp, jcfg, extra["frames"])
        tcache = registry.init_cache(tcfg, B, max_len, device="cpu")
        tcache["cross_k"], tcache["cross_v"] = multimodal.build_cross_cache(
            tp, tcfg, torch.from_numpy(extra["frames"]))
        _close_scaled(tcfg, tcache["cross_k"], jcache["cross_k"])
        _close_scaled(tcfg, tcache["cross_v"], jcache["cross_v"])
        pos0 = S0
    for i in range(steps):
        pos = np.full((B,), pos0 + i, np.int32)
        want, jcache = jregistry.decode_step(jp, jcfg, jcache, {
            "token": jnp.asarray(tokens[:, S0 + i]), "position": jnp.asarray(pos)})
        got, tcache = registry.decode_step(tp, tcfg, tcache, {
            "token": torch.from_numpy(tokens[:, S0 + i]), "position": torch.from_numpy(pos)})
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close_scaled(tcfg, got, want)
    _close_scaled(tcfg, tcache["k"], jcache["k"])
    _close_scaled(tcfg, tcache["v"], jcache["v"])


def test_decode_matches_forward(model):
    """tests/test_models.py on the port: whisper's decode (cross cache from
    ``build_cross_cache``) from an empty cache reproduces the teacher-forced
    forward, and pixtral's prefill of patches + 4 tokens then decode
    reproduces the forward (``test_vlm_prefill_then_decode``), each within
    2e-2 of max|logits|."""
    _, tcfg, _, tp = model
    S = 12 if tcfg.family == "vlm" else 10
    b = registry.make_batch(tcfg, SHAPES["prefill_32k"], batch_override=2, seq_override=S,
                            device="cpu")
    full, _ = registry.forward(tp, tcfg, b)
    if tcfg.family == "vlm":
        P = tcfg.num_patches
        plog, cache = transformer.prefill_step(
            tp, tcfg, {"tokens": b["tokens"][:, :4], "patches": b["patches"]}, max_len=S)
        errs = [float((plog.float() - full[:, : P + 4].float()).abs().max())]
        steps = range(4, S - P)
    else:
        P, cache = 0, registry.init_cache(tcfg, 2, S, device="cpu")
        cache["cross_k"], cache["cross_v"] = multimodal.build_cross_cache(tp, tcfg, b["frames"])
        errs, steps = [], range(S)
    for t in steps:
        lg, cache = registry.decode_step(tp, tcfg, cache, {
            "token": b["tokens"][:, t], "position": torch.full((2,), P + t, dtype=torch.int32)})
        errs.append(float((lg - full[:, P + t].float()).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-2


def test_encode_matches_reference():
    jcfg = jax_get_config("whisper-large-v3", reduced=True)
    tcfg = get_config("whisper-large-v3", reduced=True)
    np_params = _np_params(jcfg)
    frames = _extra(tcfg, 2)["frames"]
    want = jmm.encode(jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(frames))
    got = multimodal.encode(transformer.params_from_jax(np_params, device="cpu"), tcfg,
                            torch.from_numpy(frames))
    _close(got, want)


def test_generate_token_streams_equal_reference(model):
    jcfg, tcfg, jp, tp = model
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    extra = _extra(tcfg, 3)
    max_len = 16 + tcfg.num_patches
    want = jserve.generate(jcfg, jp, jnp.asarray(tokens), 6, max_len,
                           jax.tree.map(jnp.asarray, extra))
    got = serve.generate(tcfg, tp, torch.from_numpy(tokens), 6, max_len, _torch_batch(extra))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES + ("phi3.5-moe-42b-a6.6b",))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_make_batch_is_the_reference_batch(arch, shape):
    cfg, jcfg = get_config(arch, True), jax_get_config(arch, True)
    kw = dict(batch_override=3, seq_override=24)
    want = jregistry.make_batch(jcfg, JSHAPES[shape], np.random.default_rng(11), **kw)
    got = registry.make_batch(cfg, SHAPES[shape], np.random.default_rng(11), device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", FAMILIES + ("phi3.5-moe-42b-a6.6b",))
def test_batch_at_step_is_the_reference_batch(arch):
    cfg, jcfg = get_config(arch, True), jax_get_config(arch, True)
    got = synthetic.batch_at_step(cfg, SHAPES["train_4k"], 3, 17, 3, 40)
    want = jsynthetic.batch_at_step(jcfg, JSHAPES["train_4k"], 3, 17, 3, 40)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    if cfg.family == "vlm":
        assert (got["labels"][:, : cfg.num_patches] == -1).all()


def test_launch_train_matches_reference_run_training(monkeypatch):
    arch = "whisper-large-v3"
    jcfg = jax_get_config(arch, reduced=True)
    kw = dict(num_steps=3, seed=0, batch_override=2, seq_override=16, log_every=100,
              log_fn=lambda *a: None)
    _, jlosses, _ = jtrain_loop.run_training(jcfg, JSHAPES["train_4k"], **kw)
    np_init = jax.tree.map(np.asarray, jtrain_loop.init_train_state(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(train_loop, "init_train_state", lambda cfg, seed, device=None:
                        train_loop.state_from_jax(np_init, device=device))
    state, losses, _ = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                                   "--batch", "2", "--seq", "16", "--log-every", "100"])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    assert int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("arch", NEW)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    how = "fed token by token" if arch.startswith("whisper") else "prefilled in one pass"
    assert "generated (2, 8)" in out and "on cpu" in out and how in out


def test_engine_serves_the_reference_engines_families():
    params = {"embed": torch.zeros(1)}
    for arch in FAMILIES:
        with pytest.raises(NotImplementedError, match="dense, moe"):
            teng.PagedModel(get_config(arch, True), params, num_blocks=4, block_size=2,
                            max_slots=1, max_blocks_per_seq=2, device="cpu")
