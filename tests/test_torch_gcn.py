"""Port GCN path (GEMM, ELL SpMM, the GCN model and its entry point) vs
the JAX reference on the CPU.

The same numpy inputs (seeded) go through ``repro.kernels.ops`` and
``repro_torch.hopper.ops``. GEMM and SpMM are held to the Pallas bodies
themselves (``impl="interpret"``) at the reference suite's tolerances:
fp32 ``rtol=atol=1e-5``, bf16 ``rtol=2e-2, atol=1e-2``. The port's
``cuda`` wrapper, given CPU tensors, runs the plain version and counts no
launch. ``gcn.forward`` and the full-width webkb run of
``launch/gcn_inference.run`` take the reference's weights through
``params_from_jax`` and the reference example's adjacency and features
from the same seed. The Hopper kernels themselves run only on the card:
their tests here are marked ``cuda`` and skip without one.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sparse as jsp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro.models import gcn as jgcn  # noqa: E402
from repro_torch.core import sparse as tsp  # noqa: E402
from repro_torch.hopper import dispatch, ops  # noqa: E402
from repro_torch.launch import gcn_inference  # noqa: E402
from repro_torch.models import gcn  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)  # tests/test_kernels.py: RTOL, atol 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "gcn_inference.py"


def _example():
    """The reference's ``examples/gcn_inference.py`` (its ``main`` runs only
    as a script)."""
    spec = importlib.util.spec_from_file_location("reference_gcn_inference", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("out", ["float32", "default"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (100, 70, 130), (256, 128, 64)])
def test_gemm_matches_jax_pallas_body(rng, m, k, n, dtype, out):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jd, td = DTYPES[dtype]
    jout, tout = (jnp.float32, torch.float32) if out == "float32" else (None, None)
    want = jops.gemm(jnp.asarray(a, jd), jnp.asarray(b, jd), impl="interpret", out_dtype=jout)
    ta, tb = torch.from_numpy(a).to(td), torch.from_numpy(b).to(td)
    tol = F32_TOL if dtype == "float32" and out == "float32" else BF16_TOL
    dispatch.reset_launches()
    for impl in (None, "cuda", "torch", "ref"):
        got = ops.gemm(ta, tb, impl=impl, out_dtype=tout)
        assert got.dtype == (tout or td)
        np.testing.assert_allclose(_np32(got), _np32(want), **tol)
    assert dispatch.LAUNCHES["gemm"] == 0  # CPU tensors take the plain version


def test_gemm_argument_checks(rng):
    a = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="accum_dtype"):
        ops.gemm(a, a.T, accum_dtype=torch.bfloat16)
    out = ops.gemm(a, a.T, precision="fp8")  # the precision slice runs, fp32 out
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 8)
    with pytest.raises(NotImplementedError, match="mesh"):
        ops.gemm(a, a.T, precision="fp8", mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        ops.gemm(a, a.T, mesh=object())
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gemm(meta, meta.T, impl="cuda")
    # the plain form's blocks resolve through the table (and reach only it)
    np.testing.assert_allclose(ops.gemm(a, a.T, bm=2, bk=2, bn=2).numpy(),
                               (a @ a.T).numpy(), **F32_TOL)


@pytest.mark.parametrize("r,c,density", [(64, 96, 0.1), (128, 256, 0.02), (30, 50, 0.3)])
def test_spmm_matches_jax_pallas_body(rng, r, c, density):
    seed = int(rng.integers(1 << 31))
    A = tsp.random_ell(np.random.default_rng(seed), r, c, density)
    jA = jsp.random_ell(np.random.default_rng(seed), r, c, density)
    D = rng.standard_normal((c, 40)).astype(np.float32)
    want = np.asarray(jops.spmm(jA.values, jA.cols, jnp.asarray(D), impl="interpret"))
    np.testing.assert_allclose(want, np.asarray(jA.todense()) @ D, rtol=1e-4, atol=1e-4)
    tD = torch.from_numpy(D)
    dispatch.reset_launches()
    for impl in (None, "cuda", "torch", "ref"):
        for got in (ops.spmm(A, tD, impl=impl),
                    ops.spmm(A.values, A.cols, tD, impl=impl),
                    ops.spmm(A, dense=tD, impl=impl)):
            np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert dispatch.LAUNCHES["spmm"] == 0
    # the plain form sums slot by slot in the same order for every bm
    assert torch.equal(ops.spmm(A, tD, impl="torch", bm=8), ops.spmm(A, tD, impl="torch"))


def test_spmm_argument_checks(rng):
    A = tsp.random_ell(rng, 8, 8, 0.25)
    D = torch.ones((8, 4))
    with pytest.raises(TypeError, match="extra operand"):
        ops.spmm(A, A.cols, D)
    with pytest.raises(TypeError, match="required"):
        ops.spmm(A)
    with pytest.raises(TypeError, match="required"):
        ops.spmm(A.values, A.cols)
    with pytest.raises(NotImplementedError, match="mesh"):
        ops.spmm(A, D, mesh=object())
    meta = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.spmm(meta, meta.int(), torch.empty((8, 4), device="meta"), impl="cuda")


def test_dispatch_tables_match_the_reference():
    for op in ("gemm", "spmm"):
        assert dispatch.resolve_impl(op) == "cuda"
        assert dispatch.implementations(op) == ["cuda", "ref", "torch"]
        assert dispatch._BLOCK_DEFAULTS[op] == jregistry._BLOCK_DEFAULTS[op]
    with dispatch.block_override("spmm", bm=16):
        assert dispatch.resolve_blocks("spmm") == {"bm": 16}
    assert dispatch.resolve_blocks("spmm") == {"bm": 128}


def test_gcn_forward_matches_jax(rng):
    jparams = jgcn.init_params(jax.random.PRNGKey(0), [16, 32, 8])
    jA = jsp.random_ell(np.random.default_rng(0), 64, 64, 0.05)
    A = tsp.random_ell(np.random.default_rng(0), 64, 64, 0.05)
    feats = rng.standard_normal((64, 16)).astype(np.float32)
    with jregistry.default_impl("interpret"):
        want = np.asarray(jgcn.forward(jparams, jA, jnp.asarray(feats)))
    params = gcn.params_from_jax(jparams, device="cpu")
    got = gcn.forward(params, A, torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # one layer, with and without the activation
    for activate in (True, False):
        with jregistry.default_impl("interpret"):
            want1 = jgcn.gcn_layer(jparams[0], jA, jnp.asarray(feats), activate=activate)
        got1 = gcn.gcn_layer(params[0], A, torch.from_numpy(feats), activate=activate)
        np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **F32_TOL)


def test_full_width_webkb_run_matches_the_reference_example():
    """The slice as a whole: the entry point on webkb (877 nodes, 144
    features, two layers) against the reference example's forward on the
    same seed, graph, features and weights."""
    ex = _example()
    assert tuple(ex.GRAPHS) == gcn_inference.GRAPHS and ex.FEATURES == gcn_inference.FEATURES
    rng = np.random.default_rng(0)
    jparams = jgcn.init_params(jax.random.PRNGKey(0), [ex.FEATURES] * 3)
    name, n, deg = ex.GRAPHS[0]
    adj = ex.adjacency(rng, n, deg)
    feats = jnp.asarray(rng.standard_normal((n, ex.FEATURES)), jnp.float32)
    want = np.asarray(jgcn.forward(jparams, adj, feats))

    runs = gcn_inference.run(device="cpu", seed=0, graphs=gcn_inference.GRAPHS[:1],
                             params=gcn.params_from_jax(jparams, device="cpu"))
    assert len(runs) == 1 and runs[0].name == name
    r = runs[0]
    np.testing.assert_array_equal(r.adj.values.numpy(), np.asarray(adj.values))
    np.testing.assert_array_equal(r.adj.cols.numpy(), np.asarray(adj.cols))
    np.testing.assert_array_equal(r.feats.numpy(), np.asarray(feats))
    assert r.out.shape == (n, ex.FEATURES) and r.forward_ms > 0
    np.testing.assert_allclose(r.out.numpy(), want, **F32_TOL)


def test_run_draws_its_own_params_on_the_given_device():
    runs = gcn_inference.run(device="cpu", seed=3, graphs=(("tiny", 40, 2.0),))
    params = gcn.init_params([gcn_inference.FEATURES] * 3, seed=3, device="cpu")
    r = runs[0]
    assert torch.equal(r.out, gcn.forward(params, r.adj, r.feats))
    assert [tuple(w.shape) for w in params] == [(144, 144), (144, 144)]
    assert float(params[0].std()) == pytest.approx(1 / 12, rel=0.05)  # 1/sqrt(fan_in)


def test_entry_points_raise_without_cuda_and_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn.init_params([4, 4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn.params_from_jax([np.ones((4, 4), np.float32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn_inference.run(graphs=(("tiny", 8, 2.0),))


@pytest.mark.cuda
def test_cuda_gemm_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper GEMM kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, out, tol in ((torch.float32, torch.float32, 1e-4),
                            (torch.bfloat16, torch.float32, 1e-4),
                            (torch.bfloat16, torch.bfloat16, 1e-2)):
        a = torch.randn((257, 129), generator=gen, device="cuda").to(dtype)
        b = torch.randn((129, 65), generator=gen, device="cuda").to(dtype)
        got = ops.gemm(a, b, impl="cuda", out_dtype=out)
        want = ops.gemm(a, b, impl="torch", out_dtype=out)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_spmm_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper SpMM kernel has no CPU mode")
    A = tsp.random_ell(np.random.default_rng(0), 300, 400, 0.1).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        dense = torch.randn((400, 144), generator=gen, device="cuda").to(dtype)
        got = ops.spmm(A, dense, impl="cuda")
        want = ops.spmm(A, dense, impl="torch")
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
