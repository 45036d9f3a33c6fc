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
from the same seed. A narrow GEMM accumulator is held to both of the
reference's forms (see ``ACCUM_PAIRS``). The Hopper kernels themselves run
only on the card: their tests here are marked ``cuda`` and skip without
one.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the `cuda`-marked tests run there
    import jax
    import jax.numpy as jnp
    from repro.core import sparse as jsp
    from repro.kernels import ops as jops
    from repro.kernels import registry as jregistry
    from repro.models import gcn as jgcn
except ImportError:
    jax = jnp = jsp = jops = jregistry = jgcn = None
from repro_torch.core import sparse as tsp  # noqa: E402
from repro_torch.hopper import dispatch, ops  # noqa: E402
from repro_torch.hopper import gemm as gemm_wrapper  # noqa: E402
from repro_torch.launch import gcn_inference  # noqa: E402
from repro_torch.models import gcn  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)  # tests/test_kernels.py: RTOL, atol 1e-2
DTYPES = {name: (getattr(jnp, name, None), getattr(torch, name)) for name in ("float32", "bfloat16")}
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
    # a narrow accumulator runs (one K block here), fp32 out by default
    out = ops.gemm(a, a.T, accum_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    assert torch.equal(out, (a @ a.T).to(torch.bfloat16).float())
    out = ops.gemm(a, a.T, precision="fp8")  # the precision slice runs, fp32 out
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 8)
    with pytest.raises(TypeError, match="mesh"):
        ops.gemm(a, a.T, precision="fp8", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
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
    with pytest.raises(TypeError, match="mesh"):
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


# A narrow accumulator (ops.gemm accum_dtype=bf16 / fp16). The reference
# has two forms: ``ref`` (and ``xla``) is one matmul with
# preferred_element_type=accum_dtype, which XLA on the CPU computes as an fp32
# dot rounded once to accum_dtype (for bf16 operands with an fp16
# accumulator, rounded to bf16 first); the Pallas body (``interpret``) rounds
# each K block's fp32 dot to accum_dtype and adds it into an accumulator
# rounded after each add. The port's ``torch`` impl is the first
# (``ref.gemm_ref``), the ``cuda`` wrapper's plain version the second
# (``blocked.gemm_accum_blocked``). Two fp32 orders of a block's sum may
# round to neighbouring values, and a running sum carries such a step on:
# each entry is held within one step of the coarser of the operand and
# accumulator types at max|C| per K block, and, where both sides round the
# same fp32 sum once, at least 99% of the entries are equal bitwise.
ACCUM_PAIRS = [("float32", "bfloat16"), ("float32", "float16"),
               ("bfloat16", "bfloat16"), ("bfloat16", "float16")]


def _accum_tol(dtype, accum, blocks, scale):
    eps = max(torch.finfo(getattr(torch, dtype)).eps, torch.finfo(getattr(torch, accum)).eps)
    return blocks * eps * scale


@pytest.mark.parametrize("k,bk", [(700, None), (700, 128), (96, None)])
@pytest.mark.parametrize("dtype,accum", ACCUM_PAIRS)
def test_gemm_narrow_accumulator_matches_jax(rng, dtype, accum, k, bk):
    m, n = 40, 56
    jd, td = DTYPES[dtype]
    ja = jnp.asarray(rng.standard_normal((m, k)), jd)
    jb = jnp.asarray(rng.standard_normal((k, n)), jd)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(td)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(td)
    blocks = -(-k // min(bk or 256, k))
    forms = {}
    for jimpl, timpl, nb in (("ref", "torch", 1), ("interpret", "cuda", blocks)):
        want = _np32(jops.gemm(ja, jb, accum_dtype=getattr(jnp, accum), impl=jimpl, bk=bk))
        got = ops.gemm(ta, tb, accum_dtype=getattr(torch, accum), impl=timpl, bk=bk)
        assert got.dtype == td
        got = forms[timpl] = _np32(got)
        diff = np.abs(got - want)
        assert diff.max() <= _accum_tol(dtype, accum, nb, np.abs(want).max()), (jimpl, diff.max())
        if (dtype, accum) != ("bfloat16", "float16"):
            assert np.mean(got == want) >= 0.99, jimpl
    if blocks > 1:  # per block and once are different functions
        assert (forms["cuda"] != forms["torch"]).any()


def test_gemm_narrow_accumulator_sums_per_block():
    """The per-block form, entry by entry: fp32 partials of K blocks of 2,
    each rounded to bf16, added into a bf16 running sum."""
    a = torch.tensor([[1.0, 2 ** -9, 2 ** -9, 2 ** -9]])
    b = torch.ones((4, 1))
    # one rounding of the whole sum: 1 + 3 * 2^-9 -> 1 + 2^-7 (nearest bf16)
    assert ops.gemm(a, b, accum_dtype=torch.bfloat16, impl="torch").item() == 1 + 2 ** -7
    # blocks [1, 2^-9] -> 1 (ties to even), then [2^-9, 2^-9] -> 2^-8; 1 + 2^-8 -> 1
    assert ops.gemm(a, b, accum_dtype=torch.bfloat16, impl="cuda", bk=2).item() == 1.0
    assert ops.gemm(a, b, accum_dtype=torch.float16, impl="cuda", bk=2).item() == 1 + 3 * 2 ** -9


@pytest.mark.cuda
def test_cuda_gemm_narrow_accumulator_matches_per_block_plain_version():
    """Both kernels (fp32 FFMA, bf16 mma) with bf16 and fp16 accumulators,
    K blocks of 256 (ragged last block) and of 64, against the per-block
    plain version at the CPU tests' tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper GEMM kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in ("float32", "bfloat16"):
        for accum in ("bfloat16", "float16"):
            for m, k, n, bk in ((257, 1000, 65, 256), (100, 70, 130, 256), (64, 512, 144, 64)):
                a = torch.randn((m, k), generator=gen, device="cuda").to(getattr(torch, dtype))
                b = torch.randn((k, n), generator=gen, device="cuda").to(getattr(torch, dtype))
                kw = dict(accum_dtype=getattr(torch, accum), bk=bk, out_dtype=torch.float32)
                got = ops.gemm(a, b, impl="cuda", **kw)
                want = gemm_wrapper.blocked.gemm_accum_blocked(
                    a, b, bk=min(bk, k), accum_dtype=kw["accum_dtype"], out_dtype=torch.float32)
                tol = _accum_tol(dtype, accum, -(-k // min(bk, k)), float(want.abs().max()))
                assert float((got - want.float()).abs().max()) <= tol
                assert float((got == want.float()).float().mean()) >= 0.99


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


# ---------------------------------------------------------------------------
# the fp32 kernel's planner (pure Python; the kernel takes its plan)
# ---------------------------------------------------------------------------

SMS = 132  # an H100 SXM
PLAN_SHAPES = [  # (M, N, K): the GCN graphs' and ogbn-arxiv's, ragged, wide, tiny
    (169343, 144, 144), (2708, 144, 144), (3327, 144, 144), (19717, 144, 144),
    (100, 130, 70), (257, 65, 129), (1, 1, 1), (5, 144, 1000), (33, 193, 144),
    (4096, 1, 144), (1000, 1024, 2048), (300, 96, 64),
]


def _thread_cells(plan):
    """The (row, column) cells of a tile that each thread of the CTA owns,
    by csrc/gemm.cu's mapping: rows row0 + 8 i, columns col0 + 16 wc j + e."""
    cells = []
    for t in range(plan.threads):
        warp, lane = divmod(t, 32)
        row0 = (warp // plan.wc) * 8 * plan.tm + lane // 4
        col0 = ((warp % plan.wc) * 4 + lane % 4) * 4
        cells += [(row0 + 8 * i, col0 + 16 * plan.wc * j + e)
                  for i in range(plan.tm) for j in range(3) for e in range(4)]
    return cells


def _row_range(plan, m, cta):
    """Rows [begin, end) of CTA ``cta``, by csrc/gemm.cu's split: the CTAs
    of a column tile take even, consecutive shares of the row units."""
    unit, groups, g = 8 * plan.tm, plan.grid // plan.col_tiles, cta // plan.col_tiles
    return g * plan.units // groups * unit, min(m, (g + 1) * plan.units // groups * unit)


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_gemm_plan_covers_every_output_once(m, n, k):
    plan = gemm_wrapper.plan_f32(m, n, k, SMS, True)
    # one tile: the CTA's threads own each of its bm x bn cells once
    count = np.zeros((plan.bm, plan.bn), np.int64)
    for r, c in _thread_cells(plan):
        count[r, c] += 1
    assert (count == 1).all()
    # the grid: CTA b keeps column tile b % col_tiles; the CTAs of a column
    # tile split [0, M) into consecutive row ranges, none empty
    assert plan.grid % plan.col_tiles == 0
    assert plan.col_tiles * plan.bn >= n > (plan.col_tiles - 1) * plan.bn
    rows = np.zeros((plan.col_tiles, m), np.int64)
    for cta in range(plan.grid):
        begin, end = _row_range(plan, m, cta)
        assert begin < end
        rows[cta % plan.col_tiles, begin:end] += 1
    assert (rows == 1).all()
    # the busiest CTA has at most one row unit (8 tm rows) more than the least
    sizes = [np.subtract(*_row_range(plan, m, cta)[::-1]) for cta in range(plan.grid)]
    assert max(sizes) - min(sizes) <= 2 * 8 * plan.tm


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_gemm_plan_fits_the_card(m, n, k):
    g = gemm_wrapper
    plan = g.plan_f32(m, n, k, SMS, True)
    assert plan.smem == g.smem_bytes(plan.tm, plan.wr, plan.wc, k, plan.stages, plan.resident)
    assert plan.smem <= g.SMEM_PER_CTA == 227 * 1024
    assert plan.ctas_per_sm * (plan.smem + 1024) <= g.SMEM_PER_SM
    assert plan.threads <= g.MAX_THREADS
    assert plan.ctas_per_sm * plan.threads * g.REGS <= 65536
    assert 2 <= plan.stages <= g.MAX_STAGES
    assert 1 <= plan.grid // plan.col_tiles <= plan.units
    assert plan.grid <= SMS * plan.ctas_per_sm


def test_gemm_plan_shapes_of_the_gcn_path():
    """ogbn-arxiv: B resident, no padded column, the busiest CTA within 5%
    of an even share of the rows. cora: row shares small enough that every
    SM has a warp. A panel of B larger than shared memory streams."""
    big = gemm_wrapper.plan_f32(169343, 144, 144, SMS, True)
    assert big.resident and big.col_tiles * big.bn == 144
    groups = big.grid // big.col_tiles
    assert -(-big.units // groups) <= 1.05 * big.units / groups
    cora = gemm_wrapper.plan_f32(2708, 144, 144, SMS, True)
    # 128-row tiles a CTA would leave 110 of 132 SMs idle: here each warp
    # row holds at most two row units, and the warps with work outnumber
    # the SMs
    rows = [np.subtract(*_row_range(cora, 2708, b)[::-1]) for b in range(cora.grid)]
    assert max(rows) <= 2 * cora.bm
    unit = 8 * cora.tm
    assert sum(min(cora.wr, -(-r // unit)) * cora.wc for r in rows) >= SMS
    wide = gemm_wrapper.plan_f32(1000, 1024, 2048, SMS, True)
    assert not wide.resident  # 2048 x bn floats exceed the shared memory
    assert wide.stages >= 3


def test_gemm_takes_16_byte_copies_only_for_aligned_rows():
    wide = torch.zeros((500, 200))
    w = torch.zeros((144, 144))
    assert gemm_wrapper.vec16(wide[:, :144], w)
    assert not gemm_wrapper.vec16(wide[:, 30:174], w)  # rows start 120 bytes in
    assert not gemm_wrapper.vec16(torch.zeros((50, 202))[:, :144], w)  # row stride 808 B
    assert not gemm_wrapper.vec16(wide[:, :144], torch.zeros((144, 146))[:, :144])
    assert gemm_wrapper.vec16(wide[:, 4:148], w)


@pytest.mark.cuda
def test_cuda_gemm_kernel_edge_shapes():
    """M below one tile and at ogbn-arxiv's size; N of 1, 65, 144 and 193;
    K of 1, 144 and 1000; a K x N panel too large to stay resident; the
    unaligned strided slice (4-byte copies): each against the plain
    version at the smoke run's tolerances. B is drawn / sqrt(K), so that C
    is of unit scale as the GCN's layers give it: unit-variance sums over
    K = 2048 reach ~200, where two fp32 summation orders differ by a few
    1e-4, beyond the absolute 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper GEMM kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(m, k, n) for m in (5, 169343) for k in (1, 144, 1000) for n in (1, 65, 144, 193)]
    shapes += [(1000, 2048, 1024)]
    for m, k, n in shapes:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        for out, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            got = ops.gemm(a, b, impl="cuda", out_dtype=out)
            want = ops.gemm(a, b, impl="torch", out_dtype=out)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    wide = torch.randn((500, 200), generator=gen, device="cuda")
    a, b = wide[:, 30:174], torch.randn((144, 144), generator=gen, device="cuda")
    assert not gemm_wrapper.vec16(a, b)
    torch.testing.assert_close(ops.gemm(a, b, impl="cuda"), ops.gemm(a, b, impl="torch"),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the ELL kernel's planner (pure Python; the kernel takes its plan)
# ---------------------------------------------------------------------------

from repro_torch.hopper import spmm as spmm_wrapper  # noqa: E402


@pytest.mark.parametrize("R,L,C,F,esize,vec_ok,want", [
    # the GCN at ogbn-arxiv size: 5 slabs of 32 columns (21.7 MB of dense each), 8 lanes a row
    (169343, 15, 169343, 144, 4, True, (4, 8, 32, 8, 32, 5292, 26460)),
    (2708, 3, 2708, 144, 4, True, (4, 8, 144, 36, 7, 387, 387)),          # cora: one slab
    (8192, 459, 16384, 256, 4, True, (4, 16, 256, 64, 4, 2048, 2048)),    # the trio at 2.8 %
    (8192, 20, 16384, 256, 4, True, (4, 16, 256, 64, 4, 2048, 2048)),     # the trio at 0.12 %
    (169343, 15, 169343, 144, 2, True, (8, 8, 64, 8, 32, 5292, 15876)),   # bf16 dense: 3 slabs of 64
    (1000, 37, 700, 33, 4, False, (1, 16, 33, 33, 7, 143, 143)),          # ragged F: 4-byte loads
    (1000, 9, 700, 1, 2, False, (1, 8, 1, 1, 256, 4, 4)),
    (300, 0, 4096, 4096, 4, True, (4, 8, 256, 64, 4, 75, 1200)),          # F past 64 vectors
])
def test_spmm_plan_tiles(R, L, C, F, esize, vec_ok, want):
    """(vec, batch, slab, lanes, rows, row_blocks, grid): 16-byte vectors
    where allowed, 16 slots a batch where a row has as many, F in one slab
    where it fits, else in the fewest slabs of whole 128-byte lines whose
    slice of dense fits ``L2_SLAB_BYTES`` (at most 64 vectors wide), as
    many whole rows a block as fit 256 threads."""
    assert tuple(spmm_wrapper.plan(R, L, C, F, esize, vec_ok)) == want


@pytest.mark.parametrize("F", [1, 33, 144, 256, 300, 4096])
@pytest.mark.parametrize("C", [700, 169343])
@pytest.mark.parametrize("esize,vec_ok", [(4, True), (4, False), (2, True), (2, False)])
def test_spmm_plan_covers_every_output_once(F, C, esize, vec_ok):
    """Every (row, column) is one thread's: a row's lanes cover the slab in
    whole vectors, a block's threads stay within 256, the blocks cover R
    and every slab, a slab of several is whole 128-byte lines, and a slab's
    slice of dense fits the L2 budget unless the slab is one line wide."""
    R, L = 1000, 15
    if vec_ok and F % (16 // esize):
        return  # the wrapper allows 16-byte loads only where F is a multiple
    q = spmm_wrapper.plan(R, L, C, F, esize, vec_ok)
    assert q.lanes * q.vec == q.slab and q.slab % q.vec == 0
    assert q.rows * q.lanes <= spmm_wrapper.THREADS and q.row_blocks * q.rows >= R > (q.row_blocks - 1) * q.rows
    assert q.grid == q.row_blocks * -(-F // q.slab)
    assert q.slab <= spmm_wrapper.MAX_LANES * q.vec
    line = spmm_wrapper.LINE_BYTES // esize
    assert q.slab >= F or q.slab % line == 0
    assert C * min(q.slab, F) * esize <= spmm_wrapper.L2_SLAB_BYTES or q.slab == line


def test_spmm_takes_16_byte_loads_only_for_aligned_rows():
    wide = torch.zeros((50, 152))
    assert spmm_wrapper.vec16(wide[:, :144])
    assert not spmm_wrapper.vec16(wide[:, :33])
    assert not spmm_wrapper.vec16(wide[:, 1:145])          # the pointer is off 16 bytes
    assert not spmm_wrapper.vec16(torch.zeros((50, 146))[:, :144])  # row stride 146
    assert spmm_wrapper.vec16(torch.zeros((50, 144), dtype=torch.bfloat16))
    assert not spmm_wrapper.vec16(torch.zeros((50, 300), dtype=torch.bfloat16))


@pytest.mark.cuda
def test_cuda_spmm_kernel_edge_shapes(monkeypatch):
    """The ELL kernel against its plain version (fp32 bitwise, bf16 one
    step): F of 1, 33, 144 and 300, also in about 4 slabs (the L2 budget
    shrunk); L of 0, 1, 9 and 37; R = 1000; values, cols and dense as row
    slices of wider tensors; every pair of value and dense types; sorted
    and unsorted slots with a repeated column; a repeated call bitwise
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper SpMM kernel has no CPU mode")
    rng = np.random.default_rng(1)
    R, C = 1000, 700
    for F in (1, 33, 144, 300):
        for L in (0, 1, 9, 37):
            for vt in (torch.float32, torch.bfloat16):
                for dt in (torch.float32, torch.bfloat16):
                    cols = rng.integers(0, C, (R, L + 3)).astype(np.int32)
                    cols[:, 1:3] = cols[:, :1]
                    wide_v = torch.from_numpy(rng.standard_normal((R, L + 3)).astype(np.float32))
                    values = wide_v.cuda().to(vt)[:, :L]
                    dense = torch.randn((C, F + 8), device="cuda").to(dt)[:, :F]
                    for srt in (True, False):
                        c = torch.from_numpy(np.sort(cols, axis=1) if srt else cols).cuda()[:, :L]
                        want = ops.spmm(values, c, dense, impl="torch")
                        for budget in (spmm_wrapper.L2_SLAB_BYTES, C * F * dense.element_size() // 4):
                            monkeypatch.setattr(spmm_wrapper, "L2_SLAB_BYTES", budget)
                            got = ops.spmm(values, c, dense, impl="cuda")
                            assert torch.equal(got, ops.spmm(values, c, dense, impl="cuda"))
                            if dt == torch.float32:
                                assert torch.equal(got, want), (F, L, vt, srt, budget)
                            else:
                                torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
                            monkeypatch.undo()
