"""Gradients of the port vs the JAX reference on the CPU.

- The two autograd Functions of ``hopper/grads.py`` (the FA kernel's
  forward with the plain FA-2 backward from the saved lse; the scan
  kernel's forward with the plain chunked form's autograd backward) pass
  ``torch.autograd.gradcheck`` in fp64 on CPU tensors, where the kernels'
  wrappers run the plain forward,
  over causal and not, a window, ``q_offset`` and GQA; ``u`` given and
  None, ``s0``, the final state's gradient and hymba's stride-0 inputs.
  The FA backward's key blocks (and the blocks it skips) change nothing.
- Every other ``cuda`` impl, the scaled attention form, ``return_lse``
  and the mesh path raise ``NotImplementedError`` on an input that
  requires grad, before anything is built.
- ``registry.loss_fn``'s loss and gradients (through the Functions on the
  CPU) against ``jax.value_and_grad(repro.models.registry.loss_fn)`` at
  the REDUCED fp32 configs (the reference's CPU impl is ``xla``), weights
  carried by ``params_from_jax``. The loss within ``rtol = 1e-4, atol =
  1e-5`` for the transformer families (dense, moe, vlm) and the audio one,
  and ``1e-3`` where the scan is in the path (its chunked fp32 sums in
  another order, compounded through the layers); each gradient leaf
  within 1e-4 (dense, moe), 2e-4 (vlm), 2e-3 (audio) or 1e-3 (scan) of
  its largest entry (GRAD_TOL says why the vlm and audio ones are wider). Not elementwise: the reference's own fp32 embedding
  gradient lies ~1e-4 of the leaf's largest entry from an fp64 run of
  the same model (occamy-gptj REDUCED), so its small entries carry
  relative errors of 1e-3 and more on both sides.
- ``remat`` "full", "dots" and "none" give bitwise the same loss and
  gradients on the CPU.
- One train step of each of the eleven configs at REDUCED size, as
  ``tests/test_models.py::test_smoke_train_step`` takes one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.sparse import dense_to_bsr, random_ell  # noqa: E402
from repro_torch.hopper import blocked, build, dispatch, grads, ops  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.parallel.mesh import DeviceMesh  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402

F64 = torch.float64
PORTED = ("occamy-gptj", "gemma-2b", "qwen1.5-4b", "qwen3-14b", "command-r-35b",
          "rwkv6-3b", "hymba-1.5b", "phi3.5-moe-42b-a6.6b", "grok-1-314b", "pixtral-12b",
          "whisper-large-v3")


FA_CASES = [  # (H, K, Sq, Sk, causal, window, q_offset)
    (2, 2, 7, 7, True, 0, 0),
    (2, 2, 6, 9, False, 0, 0),
    (4, 2, 7, 9, True, 0, 2),  # GQA, q_offset
    (4, 1, 8, 8, True, 3, 0),  # MQA, window
    (2, 1, 5, 11, False, 4, 6),  # a lookback window without causal, q_offset
]


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_function_gradcheck_fp64(case):
    H, K, Sq, Sk, causal, window, q_offset = case
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, h, s, 8, generator=g, dtype=F64, requires_grad=True)
               for h, s in ((H, Sq), (K, Sk), (K, Sk)))

    def f(q, k, v):
        return grads.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)

    assert torch.autograd.gradcheck(f, (q, k, v))


def test_flash_attention_through_ops_gradcheck_on_transposed_views():
    """The cuda impl (on the CPU: the Function over the plain forward) on
    the (B, S, H, D) -> (B, H, S, D) views the transformer passes."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 6, 4, 8, generator=g, dtype=F64, requires_grad=True)
    kv = torch.randn(1, 6, 2, 8, generator=g, dtype=F64, requires_grad=True)

    def f(q, kv):
        return ops.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                                   (2 * kv).transpose(1, 2), window=4, impl="cuda")

    assert torch.autograd.gradcheck(f, (q, kv))


@pytest.mark.parametrize("block", [1, 2, 3, 5, 64])
def test_flash_attention_bwd_key_blocks_change_nothing(block):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 9, 8, generator=g, dtype=F64, requires_grad=True)
    k = torch.randn(2, 2, 13, 8, generator=g, dtype=F64, requires_grad=True)
    v = torch.randn(2, 2, 13, 8, generator=g, dtype=F64, requires_grad=True)
    do = torch.randn(2, 4, 9, 8, generator=g, dtype=F64)
    kw = dict(causal=True, window=5, q_offset=3, scale=None)
    o, lse = blocked.flash_attention_blocked(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = grads.flash_attention_bwd(q, k, v, o.detach(), lse.detach(), do, block=block, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _la_inputs(g, B=1, H=2, T=11, N=3, M=4):
    r, k = (torch.randn(B, H, T, N, generator=g, dtype=F64) for _ in range(2))
    v = torch.randn(B, H, T, M, generator=g, dtype=F64)
    w = -0.1 - torch.rand(B, H, T, N, generator=g, dtype=F64)
    return r, k, v, w


@pytest.mark.parametrize("with_u", [True, False])
@pytest.mark.parametrize("with_s0", [True, False])
def test_linear_attention_function_gradcheck_fp64(with_u, with_s0):
    """Both outputs (o and S_final) are differentiated, so the final
    state's incoming gradient is checked too."""
    g = torch.Generator().manual_seed(3)
    r, k, v, w = (x.requires_grad_() for x in _la_inputs(g))
    u = torch.randn(2, 3, generator=g, dtype=F64, requires_grad=True) if with_u else None
    s0 = torch.randn(1, 2, 3, 4, generator=g, dtype=F64, requires_grad=True) if with_s0 else None

    def f(*args):
        return grads.linear_attention(*args, chunk=4)

    assert torch.autograd.gradcheck(f, (r, k, v, w, u, s0))


def test_linear_attention_through_ops_gradcheck_broadcast_inputs():
    """hymba's SSD inputs through ``ops.linear_attention`` (cuda impl):
    r and k shared by the heads and the decay shared by the state's rows,
    stride-0 views, with the decay floor outside the Function."""
    g = torch.Generator().manual_seed(4)
    C = torch.randn(1, 1, 9, 3, generator=g, dtype=F64, requires_grad=True)
    Bm = torch.randn(1, 1, 9, 3, generator=g, dtype=F64, requires_grad=True)
    v = torch.randn(1, 2, 9, 4, generator=g, dtype=F64, requires_grad=True)
    dt = (0.05 + torch.rand(1, 2, 9, 1, generator=g, dtype=F64) * 3).requires_grad_()

    def f(C, Bm, v, dt):
        shape = (1, 2, 9, 3)
        return ops.linear_attention(C.expand(shape), Bm.expand(shape), v, (-dt).expand(shape),
                                    chunk=4, impl="cuda")

    assert torch.autograd.gradcheck(f, (C, Bm, v, dt))


# ---------------------------------------------------------------------------
# no silent zero gradients
# ---------------------------------------------------------------------------


def _no_build(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a kernel was built")

    monkeypatch.setattr(build, "load", refuse)


def _calls(x):
    """(label, thunk) for every cuda impl without a gradient; ``x`` marks
    the operand that requires grad."""
    g = torch.Generator().manual_seed(5)
    a = torch.randn(16, 16, generator=g)
    ell = random_ell(np.random.default_rng(0), R=16, C=16, density=0.25)
    bsr = dense_to_bsr(torch.randn(16, 256, generator=g), bm=8, bk=128)
    grid = torch.randn(8, 8, 8, generator=g)
    q = torch.randn(1, 2, 8, 16, generator=g)
    rg = x(a)
    return [
        ("gemm", lambda: ops.gemm(rg, a, impl="cuda")),
        ("gemm_scaled", lambda: ops.gemm(a, rg, precision="bf16", impl="cuda")),
        ("spmm", lambda: ops.spmm(x(ell.values), ell.cols, a, impl="cuda")),
        ("spmm dense", lambda: ops.spmm(ell, rg, impl="cuda")),
        ("bsr_spmm", lambda: ops.bsr_spmm(x(bsr.tile_values), bsr.tile_rows, bsr.tile_cols,
                                          torch.randn(256, 4), 16, impl="cuda")),
        ("spmspm", lambda: ops.spmspm(x(ell.values), ell.cols, ell.values, ell.cols, 16,
                                      impl="cuda")),
        ("stencil", lambda: ops.stencil(x(grid), np.array([[0, 0, 0], [1, 0, 0]]),
                                        np.array([0.5, 0.5], np.float32), impl="cuda")),
        ("flash_attention scaled", lambda: ops.flash_attention(x(q), q, q, precision="fp8",
                                                               impl="cuda")),
        ("flash_attention lse", lambda: ops.flash_attention(x(q), q, q, return_lse=True,
                                                            impl="cuda")),
        ("mesh", lambda: ops.gemm(rg, a, impl="torch",
                                  mesh=DeviceMesh({"data": 2}, device="cpu"))),
        ("decode_attention", lambda: ops.decode_attention(x(q[:, :, 0]), q, q, torch.tensor([7]),
                                                          impl="cuda")),
    ]


NO_GRAD_CALLS = ("gemm", "gemm_scaled", "spmm", "spmm dense", "bsr_spmm", "spmspm", "stencil",
                 "flash_attention scaled", "flash_attention lse", "mesh", "decode_attention")


@pytest.mark.parametrize("label", NO_GRAD_CALLS)
def test_ops_without_a_gradient_raise_before_any_build(label, monkeypatch):
    _no_build(monkeypatch)
    assert [c[0] for c in _calls(lambda t: t)] == list(NO_GRAD_CALLS)
    thunk = dict(_calls(lambda t: t.clone().requires_grad_()))[label]
    with pytest.raises(NotImplementedError, match="no gradient"):
        thunk()
    with torch.no_grad():  # the same call without grad runs
        dict(_calls(lambda t: t.clone().requires_grad_()))[label]()


def test_kernel_ops_carry_gradients_of_the_plain_form():
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 4, 16, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 2, 16, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 2, 16, 8, generator=g, requires_grad=True)
    dispatch.reset_launches()
    outs = {impl: torch.autograd.grad(ops.flash_attention(q, k, v, window=5, impl=impl).sum(),
                                      (q, k, v)) for impl in ("cuda", "torch")}
    for a, b in zip(*outs.values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    r, kk, w = (torch.randn(2, 3, 20, 4, generator=g) for _ in range(3))
    vv = torch.randn(2, 3, 20, 5, generator=g, requires_grad=True)
    u = torch.randn(3, 4, generator=g, requires_grad=True)
    outs = {}
    for impl in ("cuda", "torch"):
        o, S = ops.linear_attention(r, kk, vv, -w.abs(), u, impl=impl)
        outs[impl] = torch.autograd.grad(o.sum() + S.square().sum(), (vv, u))
    for a, b in zip(*outs.values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert not dispatch.LAUNCHES  # the CPU runs no kernel


# ---------------------------------------------------------------------------
# the models' loss and gradients vs jax.value_and_grad
# ---------------------------------------------------------------------------


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


LOSS_TOL = {"dense": dict(rtol=1e-4, atol=1e-5), "ssm": dict(rtol=1e-3, atol=1e-3),
            "hybrid": dict(rtol=1e-3, atol=1e-3), "moe": dict(rtol=1e-4, atol=1e-5),
            "vlm": dict(rtol=1e-4, atol=1e-5), "audio": dict(rtol=1e-4, atol=1e-5)}
# a gradient leaf's largest |port - reference| over its largest |reference|
# (vlm 2e-4, audio 2e-3: the stacked init's 1/sqrt(num_layers) scale makes
# their REDUCED attention near one-hot, whisper's most, on 16 non-causal
# frames; both sides' forward logits already lie ~5e-4 of their largest
# from an fp64 run there, tests/test_torch_multimodal.py)
GRAD_TOL = {"dense": 1e-4, "ssm": 1e-3, "hybrid": 1e-3, "moe": 1e-4, "vlm": 2e-4, "audio": 2e-3}


@pytest.mark.parametrize("arch", ["occamy-gptj", "gemma-2b", "rwkv6-3b", "hymba-1.5b",
                                  "phi3.5-moe-42b-a6.6b", "pixtral-12b", "whisper-large-v3"])
def test_loss_and_grads_match_jax_value_and_grad(arch):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    np_params = jax.tree.map(np.asarray, jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    nb = _batch(cfg)
    if cfg.family in ("vlm", "audio"):  # with the patches or frames, in the reference's order
        nb = {k: np.array(v) for k, v in jregistry.make_batch(
            jcfg, JSHAPES["train_4k"], np.random.default_rng(0), 2, 16).items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jregistry.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, nb)))(
        jax.tree.map(jnp.asarray, np_params))
    params = params_from_jax(np_params, device="cpu")
    loss, tgrads = train_loop.loss_and_grads_fn(cfg)(
        params, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL[cfg.family])
    tol = GRAD_TOL[cfg.family]
    paths, got = tree.flatten_with_paths(tgrads)
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for path, a, b in zip(paths, got, want):
        assert tuple(a.shape) == b.shape, path
        b = np.asarray(b)
        if path.endswith("/cbk"):
            # the cross-attention's key bias (no rope there) shifts a
            # query's every score alike, which the softmax cancels: its
            # exact gradient is zero, and both sides hold fp32 rounding
            # noise there
            assert float(np.abs(a.numpy()).max()) <= 1e-6 and float(np.abs(b).max()) <= 1e-6
            continue
        err = float(np.abs(a.numpy() - b).max())
        assert err <= tol * float(np.abs(b).max()), (path, err, float(np.abs(b).max()))


@pytest.mark.parametrize("arch", ["occamy-gptj", "rwkv6-3b", "hymba-1.5b"])
def test_remat_modes_bitwise_equal(arch):
    base = get_config(arch, reduced=True)
    params = registry.init_params(base, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(base).items()}
    results = {}
    for remat in ("full", "dots", "none"):
        cfg = base.replace(remat=remat)
        results[remat] = train_loop.loss_and_grads_fn(cfg)(params, batch)
    ref_loss, ref_grads = results["none"]
    for remat in ("full", "dots"):
        loss, grads_ = results[remat]
        assert torch.equal(loss, ref_loss), remat
        for a, b in zip(tree.leaves(grads_), tree.leaves(ref_grads)):
            assert torch.equal(a, b), remat
    with torch.no_grad():  # inference: remat leaves the forward as it is
        assert torch.equal(registry.forward(params, base, batch)[0],
                           registry.forward(params, base.replace(remat="none"), batch)[0])


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_train_step(arch):
    cfg = get_config(arch, reduced=True)
    state = train_loop.init_train_state(cfg, 0, device="cpu")
    before = [p.clone() for p in tree.leaves(state["params"])]
    batch = registry.make_batch(cfg, SHAPES["train_4k"], batch_override=2, seq_override=16,
                                device="cpu")
    state, metrics = train_loop.make_train_step(cfg)(state, batch)
    loss = float(metrics["loss"])
    assert loss > 0 and np.isfinite(loss)
    assert float(metrics["grad_norm"]) > 0
    assert int(state["opt"]["step"]) == 1
    assert any(float((a.float() - b.float()).abs().max()) > 0
               for a, b in zip(tree.leaves(state["params"]), before))
