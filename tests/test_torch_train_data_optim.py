"""The port's training data stream and optimizer vs the JAX reference on
the CPU.

``batch_at_step`` must give the reference's tokens and labels bit for bit
for every (seed, step) (both draw numpy's ``SeedSequence([seed, step])``
and ``zipf(1.3)``), and ``DataIterator`` must resume the stream at its
``start_step``. AdamW (``apply_updates``, with its global-norm clip and
warm-up schedule) runs three steps from the same parameters, moments and
gradients on both sides: fp32 leaves within ``rtol = 1e-6`` (fp32
arithmetic in another order), bf16 leaves within one bf16 step (the same
fp32 update rounded once to bf16). Gradient compression must equal the
reference's bitwise for the ``bf16`` cast and the block-scaled ``fp8``
policy (both go through the quantizer the precision tests hold bitwise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402

ARCHS = ("occamy-gptj", "rwkv6-3b", "hymba-1.5b")
FP32_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (11, 1000)])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_at_step_bitwise_reference(arch, seed, step):
    got = synthetic.batch_at_step(get_config(arch, True), SHAPES["train_4k"], seed, step,
                                  batch_override=3, seq_override=40)
    want = jsynthetic.batch_at_step(jax_get_config(arch, True), JSHAPES["train_4k"], seed,
                                    step, batch_override=3, seq_override=40)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_batch_at_step_raises_for_unported_families():
    # vlm and audio batches are ported (tests/test_torch_multimodal.py); a
    # family the port does not know raises
    cfg = get_config("occamy-gptj", True)
    with pytest.raises(NotImplementedError, match="no synthetic batches"):
        synthetic.batch_at_step(cfg.replace(family="diffusion"), SHAPES["train_4k"], 0, 0, 2, 8)


def test_data_iterator_resumes_at_start_step():
    cfg = get_config("hymba-1.5b", True)
    it = synthetic.DataIterator(cfg, SHAPES["train_4k"], seed=5, start_step=7,
                                batch_override=2, seq_override=12, device="cpu")
    try:
        for want_step in (7, 8, 9):
            step, batch = next(it)
            assert step == want_step
            ref = synthetic.batch_at_step(cfg, SHAPES["train_4k"], 5, want_step, 2, 12)
            for k, v in ref.items():
                assert batch[k].device.type == "cpu"
                np.testing.assert_array_equal(batch[k].numpy(), v)
    finally:
        it.close()
    assert not it._thread.is_alive()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _np_tree(rng, scale=1.0):
    f32 = np.float32
    return {
        "embed": (scale * rng.standard_normal((16, 8))).astype(f32),
        "layers": {"w": (scale * rng.standard_normal((2, 8, 8))).astype(jnp.bfloat16),
                   "norm": (1 + 0.1 * scale * rng.standard_normal((2, 8))).astype(f32)},
        "head": (scale * rng.standard_normal((8, 16))).astype(jnp.bfloat16),
    }


def _bf16_step_close(got, want):
    want = np.asarray(want, np.float32)
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= spacing), np.max(np.abs(got - want) / spacing)


def _close_leaf(got, want):
    if str(np.asarray(want).dtype) == "bfloat16":
        _bf16_step_close(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **FP32_TOL)


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])  # under and over the clip
def test_apply_updates_three_steps_match_reference(grad_scale):
    cfg = get_config("occamy-gptj", True).replace(warmup_steps=2, learning_rate=1e-2)
    jcfg = jax_get_config("occamy-gptj", True).replace(warmup_steps=2, learning_rate=1e-2)
    rng = np.random.default_rng(0)
    np_params = _np_tree(rng)
    jp = jax.tree.map(jnp.asarray, np_params)
    jopt = jadamw.init_state(jp)
    tp = params_from_jax(np_params, device="cpu")
    topt = adamw.init_state(tp)
    for _ in range(3):
        np_grads = _np_tree(rng, grad_scale)
        jgrads = jax.tree.map(jnp.asarray, np_grads)
        tgrads = params_from_jax(np_grads, device="cpu")
        jclip, jnorm = jadamw.clip_by_global_norm(jgrads, jcfg.grad_clip)
        tclip, tnorm = adamw.clip_by_global_norm(tgrads, cfg.grad_clip)
        np.testing.assert_allclose(float(tnorm), float(jnorm), **FP32_TOL)
        for g, w in zip(tree.leaves(tclip), jax.tree.leaves(jclip)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32_TOL)
        jp, jopt, jm = jadamw.apply_updates(jcfg, jp, jgrads, jopt)
        out = adamw.apply_updates(cfg, tp, tgrads, topt)
        assert out[0] is tp  # in place, the same tree
        tp, topt, tm = out
        assert int(topt["step"]) == int(jopt["step"])
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **FP32_TOL)
        for got, want in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype)
            _close_leaf(got, want)
        for name in ("m", "v"):
            for got, want in zip(tree.leaves(topt[name]), jax.tree.leaves(jopt[name])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_lr_schedule_matches_reference():
    cfg = get_config("gemma-2b", True)
    jcfg = jax_get_config("gemma-2b", True)
    for s in (0, 1, 37, 100, 250):
        got = adamw.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = jadamw.lr_schedule(jcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32 and float(got) == float(want)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["bf16", "fp8"])
def test_compress_decompress_bitwise_reference(policy):
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((4, 300)).astype(np.float32),
             "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                   "s": np.asarray(0.37, np.float32)}}
    err = jax.tree.map(lambda g: (1e-3 * rng.standard_normal(g.shape)).astype(np.float32), grads)
    jg, je = jcompression.compress_decompress(jax.tree.map(jnp.asarray, grads),
                                              jax.tree.map(jnp.asarray, err), policy)
    tg, te = compression.compress_decompress(params_from_jax(grads, device="cpu"),
                                             params_from_jax(err, device="cpu"), policy)
    for got, want in zip(tree.leaves(tg) + tree.leaves(te),
                         jax.tree.leaves(jg) + jax.tree.leaves(je)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zeros = compression.init_error_state(params_from_jax(grads, device="cpu"))
    assert all(z.dtype == torch.float32 and not z.any() for z in tree.leaves(zeros))
