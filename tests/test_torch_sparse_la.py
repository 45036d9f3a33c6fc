"""Port sparse-LA slice (paper Fig. 9b-d: BSR SpMM, SpMSpM, stencil and
``launch/sparse_la.py``) vs the JAX reference on the CPU.

The same numpy inputs (seeded) go through ``repro.kernels.ops`` and
``repro_torch.hopper.ops``. Each op is held to the Pallas body itself
(``impl="interpret"``) and to the reference's blocked form (``xla``) at
the reference suite's shapes and tolerance for these ops
(``tests/test_kernels.py``: rtol = atol = 1e-4), plus ragged cases: F not
a multiple of the F block, R and C not multiples of the plain form's
blocks, duplicate indices, a 2-D (X, Y, 1) stencil. The port's ``cuda``
wrappers, given CPU tensors, run the plain versions and count no launch;
the Hopper kernels themselves run only on the card, where their tests
here (marked ``cuda``) run and skip without one.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the `cuda`-marked tests run there
    import jax.numpy as jnp
    from repro.core import sparse as jsp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels import registry as jregistry
except ImportError:
    jnp = jsp = jops = jref = jregistry = None
from repro_torch.core import sparse as tsp  # noqa: E402
from repro_torch.hopper import bsr_spmm as bsr_wrapper  # noqa: E402
from repro_torch.hopper import dispatch, ops, ref  # noqa: E402
from repro_torch.launch import sparse_la  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py: bsr_spmm, spmspm, stencil
IMPLS = (None, "cuda", "torch", "ref")
JAX_IMPLS = ("interpret", "xla")
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "sparse_demo.py"

STAR = sparse_la.star(1, 3)
BOX27 = sparse_la.BOX27
STAR_R2 = sparse_la.star(2, 3)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# BSR SpMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("F,bf", [(96, None), (96, 64), (300, 128)],
                         ids=["F96", "F96-bf64", "F300-bf128"])
@pytest.mark.parametrize("bm,bk", [(8, 128), (16, 64)])
def test_bsr_spmm_matches_jax(rng, bm, bk, F, bf):
    dense_A = np.zeros((64, 256), np.float32)
    mask = rng.random((64, 256)) < 0.05
    dense_A[mask] = rng.standard_normal(mask.sum())
    jb = jsp.dense_to_bsr(dense_A, bm=bm, bk=bk)
    tb = tsp.dense_to_bsr(dense_A, bm=bm, bk=bk)
    D = rng.standard_normal((256, F)).astype(np.float32)
    oracle = dense_A @ D
    tD = torch.from_numpy(D)
    dispatch.reset_launches()
    for jimpl in JAX_IMPLS:
        want = np.asarray(jops.bsr_spmm(jb.tile_values, jb.tile_rows, jb.tile_cols,
                                        jnp.asarray(D), 64, impl=jimpl, bf=bf))
        np.testing.assert_allclose(want, oracle, **TOL)
        for impl in IMPLS:
            for got in (ops.bsr_spmm(tb, tD, impl=impl, bf=bf),
                        ops.bsr_spmm(tb, dense=tD, impl=impl),
                        ops.bsr_spmm(tb.tile_values, tb.tile_rows, tb.tile_cols, tD, 64,
                                     impl=impl)):
                assert got.dtype == torch.float32 and got.shape == (64, F)
                np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert dispatch.LAUNCHES["bsr_spmm"] == 0  # CPU tensors take the plain version


def test_bsr_spmm_row_block_without_tiles_is_zero(rng):
    """The kernel's contract where the reference's constructors never go: a
    block row with no tiles comes out 0 (the reference's blocked form
    agrees; its Pallas grid would leave that block unwritten)."""
    bm, bk = 8, 32
    rows = np.array([0, 0, 2, 3], np.int32)
    cols = np.array([0, 2, 1, 2], np.int32)
    tiles = rng.standard_normal((4, bm, bk)).astype(np.float32)
    D = rng.standard_normal((3 * bk, 40)).astype(np.float32)
    want = np.asarray(jops.bsr_spmm(jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
                                    jnp.asarray(D), 4 * bm, impl="xla"))
    args = (torch.from_numpy(tiles), torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(D), 4 * bm)
    for impl in IMPLS:
        got = ops.bsr_spmm(*args, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert not got[bm:2 * bm].any()


# ---------------------------------------------------------------------------
# SpMSpM
# ---------------------------------------------------------------------------


def _dup_ells(rng, rows, width, slots):
    """The same ELL rows with duplicate indices and an ELL padding slot,
    as the port's and the reference's EllMatrix."""
    cols = rng.integers(0, width, (rows, slots)).astype(np.int32)
    vals = rng.standard_normal((rows, slots)).astype(np.float32)
    vals[:, -1], cols[:, -1] = 0, 0
    return (tsp.EllMatrix(torch.from_numpy(vals), torch.from_numpy(cols), (rows, width)),
            jsp.EllMatrix(jnp.asarray(vals), jnp.asarray(cols), (rows, width)))


@pytest.mark.parametrize("dups", [False, True], ids=["random", "dups+padding"])
@pytest.mark.parametrize("r,c,k,bm,bn", [(48, 56, 128, None, None), (16, 128, 64, None, None),
                                         (13, 130, 64, 8, 128), (30, 20, 100, 4, 16)],
                         ids=["48x56", "16x128", "ragged-13x130", "ragged-30x20-b4x16"])
def test_spmspm_matches_jax(r, c, k, bm, bn, dups):
    seed = 11
    if dups:
        A, jA = _dup_ells(np.random.default_rng(seed), r, k, 9)
        B, jB = _dup_ells(np.random.default_rng(seed + 1), c, k, 7)
    else:
        A, jA = (m.random_ell(np.random.default_rng(seed), r, k, 0.1) for m in (tsp, jsp))
        B, jB = (m.random_ell(np.random.default_rng(seed + 1), c, k, 0.1) for m in (tsp, jsp))
    jargs = (jA.values, jA.cols, jB.values, jB.cols, k)
    oracle = np.asarray(jref.spmspm_ref(*jargs))
    dispatch.reset_launches()
    for jimpl in JAX_IMPLS:
        want = np.asarray(jops.spmspm(*jargs, impl=jimpl, bm=bm, bn=bn))
        np.testing.assert_allclose(want, oracle, **TOL)
        for impl in IMPLS:
            for got in (ops.spmspm(A, B, k, impl=impl, bm=bm, bn=bn),
                        ops.spmspm(A, B, contraction_dim=k, impl=impl),
                        ops.spmspm(A.values, A.cols, B.values, B.cols, k, impl=impl)):
                assert got.dtype == torch.float32 and got.shape == (r, c)
                np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert dispatch.LAUNCHES["spmspm"] == 0
    assert ref.spmspm_comparisons(A.cols, B.cols) == jref.spmspm_comparisons(jA.cols, jB.cols)


# ---------------------------------------------------------------------------
# Stencil
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offsets", [STAR, BOX27, STAR_R2], ids=["star7", "box27", "star13_r2"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 32, 32)])
def test_stencil_matches_jax(rng, offsets, shape):
    g = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(len(offsets)).astype(np.float32)
    _hold_stencil(g, offsets, w)


@pytest.mark.parametrize("shape,offsets", [((16, 24, 1), sparse_la.star(1, 2)),
                                           ((24, 16, 1), sparse_la.star(2, 2)),
                                           ((8, 5, 3), BOX27)],
                         ids=["j2d5pt", "j2d9pt", "box27-tiny"])
def test_stencil_2d_and_tiny_grids_match_jax(rng, shape, offsets):
    g = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(len(offsets)).astype(np.float32)
    _hold_stencil(g, offsets, w)


def _hold_stencil(g, offsets, w):
    tg = torch.from_numpy(g)
    dispatch.reset_launches()
    plain = ops.stencil(tg, offsets, w, impl="torch")
    for jimpl in JAX_IMPLS:
        want = np.asarray(jops.stencil(jnp.asarray(g), offsets, w, impl=jimpl))
        for impl in IMPLS:
            got = ops.stencil(tg, offsets, w, impl=impl)
            assert got.dtype == tg.dtype and got.shape == tg.shape
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            # every port form adds the points in the same order and roundings
            assert torch.equal(got, plain)
    assert dispatch.LAUNCHES["stencil"] == 0


def test_stencil_keeps_the_grid_dtype(rng):
    g = rng.standard_normal((8, 6, 4)).astype(np.float32)
    w = rng.standard_normal(len(STAR)).astype(np.float32)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    want = np.asarray(jops.stencil(jnp.asarray(g, jnp.bfloat16), STAR, w, impl="xla"))
    for impl in IMPLS:
        got = ops.stencil(tg, STAR, w, impl=impl)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), want.astype(np.float32), rtol=2e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# Argument forms, errors, dispatch
# ---------------------------------------------------------------------------


def test_argument_forms_and_errors(rng):
    bsr = tsp.dense_to_bsr(np.eye(16, 128, dtype=np.float32), bm=8, bk=64)
    D = torch.ones((128, 4))
    with pytest.raises(TypeError, match="extra operands"):
        ops.bsr_spmm(bsr, bsr.tile_rows, bsr.tile_cols, D)
    with pytest.raises(TypeError, match="extra operands"):
        ops.bsr_spmm(bsr, D, num_rows=16)
    with pytest.raises(TypeError, match="required"):
        ops.bsr_spmm(bsr)
    with pytest.raises(TypeError, match="required"):
        ops.bsr_spmm(bsr.tile_values, bsr.tile_rows, bsr.tile_cols, D)
    A = tsp.random_ell(rng, 8, 32, 0.2)
    with pytest.raises(TypeError, match="must also be an EllMatrix"):
        ops.spmspm(A, A.values, 32)
    with pytest.raises(TypeError, match="extra operands"):
        ops.spmspm(A, A, 32, A.cols)
    with pytest.raises(TypeError, match="required"):
        ops.spmspm(A, A)
    with pytest.raises(TypeError, match="required"):
        ops.spmspm(A.values, A.cols, A.values, A.cols)
    g = torch.zeros((8, 4, 4))
    for call in (lambda: ops.bsr_spmm(bsr, D, mesh=object()),
                 lambda: ops.spmspm(A, A, 32, mesh=object()),
                 lambda: ops.stencil(g, STAR, np.ones(7), mesh=object())):
        with pytest.raises(TypeError, match="mesh"):
            call()
    # overlap= schedules a sharded halo exchange: accepted, no-op on one device
    w = rng.standard_normal(7).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((8, 4, 4)).astype(np.float32))
    assert torch.equal(ops.stencil(g, STAR, w, overlap=False), ops.stencil(g, STAR, w))
    meta = torch.empty((3, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.bsr_spmm(meta, meta[:, 0, 0].int(), meta[:, 0, 0].int(),
                     torch.empty((128, 4), device="meta"), 16, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.spmspm(meta[0], meta[0].int(), meta[0], meta[0].int(), 64, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.stencil(torch.empty((8, 4, 4), device="meta"), STAR, w, impl="cuda")


@pytest.mark.parametrize("shape,offsets,bx", [((12, 4, 4), STAR, None),
                                              ((16, 4, 4), STAR_R2, 1)],
                         ids=["X%bx", "dx>bx"])
def test_stencil_kernel_keeps_the_reference_kernels_limits(rng, shape, offsets, bx):
    g = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(len(offsets)).astype(np.float32)
    with pytest.raises(AssertionError):
        jops.stencil(jnp.asarray(g), offsets, w, impl="interpret", bx=bx)
    with pytest.raises(ValueError, match="x-block"):
        ops.stencil(torch.from_numpy(g), offsets, w, impl="cuda", bx=bx)
    # the blocked forms take any grid, as the reference's xla/ref do
    want = np.asarray(jops.stencil(jnp.asarray(g), offsets, w, impl="xla", bx=bx))
    for impl in ("torch", "ref"):
        got = ops.stencil(torch.from_numpy(g), offsets, w, impl=impl, bx=bx)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dispatch_tables_match_the_reference():
    for op in ("bsr_spmm", "spmspm", "stencil"):
        assert dispatch.resolve_impl(op) == "cuda"
        assert dispatch.implementations(op) == ["cuda", "ref", "torch"]
        assert dispatch._BLOCK_DEFAULTS[op] == jregistry._BLOCK_DEFAULTS[op]
    with dispatch.block_override("spmspm", bm=16):
        assert dispatch.resolve_blocks("spmspm") == {"bm": 16, "bn": 128}
    assert dispatch.resolve_blocks("spmspm") == {"bm": 8, "bn": 128}


# ---------------------------------------------------------------------------
# The slice as a whole: launch/sparse_la.py against the reference
# ---------------------------------------------------------------------------

SMALL = sparse_la.Sizes(spmm=(64, 512, 40), spmspm=(40, 24, 640),
                        grid_2d=(16, 24, 1), grid_3d=(8, 12, 16))


def _reference_operands(seed, sizes):
    """The cases' operands drawn with the reference's ``random_ell`` and
    ``dense_to_bsr`` path, in the reference benches' order."""
    out = {}
    rng = np.random.default_rng(seed)
    for name, kind, offs in sparse_la.STENCILS:
        shape = sizes.grid_2d if kind == "2d" else sizes.grid_3d
        out[name] = (rng.standard_normal(shape).astype(np.float32),
                     rng.standard_normal(len(offs)).astype(np.float32))
    rng = np.random.default_rng(seed)
    R, C, F = sizes.spmm
    for d in sparse_la.DENSITIES:
        A = jsp.random_ell(rng, R, C, d)
        D = rng.standard_normal((C, F)).astype(np.float32)
        out[f"spmm{d * 100:.2f}"] = (A, D, jsp.ell_to_bsr(A, bm=8, bk=128))
    rng = np.random.default_rng(seed)
    R, C, K = sizes.spmspm
    for d in sparse_la.DENSITIES:
        out[f"spmspm{d * 100:.2f}"] = (jsp.random_ell(rng, R, K, d),
                                       jsp.random_ell(rng, C, K, 0.01))
    return out


def test_sparse_la_run_matches_the_reference_example():
    """Every case of the entry point, at a small size on the CPU, against
    ``examples/sparse_demo.py``'s calls (the Pallas bodies in interpret
    mode) recomputed in JAX on the same numpy operands."""
    spec = importlib.util.spec_from_file_location("reference_sparse_demo", EXAMPLE)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    assert demo.ops is jops  # the demo drives the reference ops, as recomputed here

    seed = 3
    cases = sparse_la.make_cases(seed, SMALL)
    dispatch.reset_launches()
    runs = sparse_la.run(device="cpu", cases=cases)
    assert not dispatch.LAUNCHES  # CPU tensors: the plain versions, no launch
    assert [r.name for r in runs] == [c.name for c in cases] == [
        "fig9b_j2d5pt_16x24", "fig9b_j2d9pt_16x24", "fig9b_j3d7pt_8x12x16",
        "fig9b_j3d13pt_8x12x16", "fig9b_j3d27pt_8x12x16",
        "fig9c_spmm_ell_d0.12pct", "fig9c_spmm_bsr_d0.12pct",
        "fig9c_spmm_ell_d1.00pct", "fig9c_spmm_bsr_d1.00pct",
        "fig9c_spmm_ell_d2.80pct", "fig9c_spmm_bsr_d2.80pct",
        "fig9d_spmspm_d0.12pct", "fig9d_spmspm_d1.00pct", "fig9d_spmspm_d2.80pct",
    ]
    refs = _reference_operands(seed, SMALL)
    for r, c in zip(runs, cases):
        assert r.wall_ms > 0 and r.merit > 0 and r.op == c.op
        if c.op == "stencil":
            name = c.name.split("_")[1]
            g, w = refs[name]
            np.testing.assert_array_equal(c.args[0].numpy(), g)
            np.testing.assert_array_equal(c.args[2], w)
            want = jops.stencil(jnp.asarray(g), c.args[1], w, impl="interpret")
        elif c.op in ("spmm", "bsr_spmm"):
            jA, D, jbsr = refs["spmm" + c.name.split("_d")[1][:-3]]
            np.testing.assert_array_equal(c.args[1].numpy(), D)
            if c.op == "spmm":
                np.testing.assert_array_equal(c.args[0].cols.numpy(), np.asarray(jA.cols))
                np.testing.assert_array_equal(c.args[0].values.numpy(), np.asarray(jA.values))
                want = jops.spmm(jA.values, jA.cols, jnp.asarray(D), impl="interpret")
            else:
                np.testing.assert_array_equal(c.args[0].tile_values.numpy(),
                                              np.asarray(jbsr.tile_values))
                np.testing.assert_array_equal(c.args[0].tile_cols.numpy(),
                                              np.asarray(jbsr.tile_cols))
                assert c.note == f"tile_density={jbsr.density:.3f}"
                want = jops.bsr_spmm(jbsr, jnp.asarray(D), impl="interpret")
        else:
            jA, jB = refs["spmspm" + c.name.split("_d")[1][:-3]]
            np.testing.assert_array_equal(c.args[0].cols.numpy(), np.asarray(jA.cols))
            np.testing.assert_array_equal(c.args[1].values.numpy(), np.asarray(jB.values))
            K = SMALL.spmspm[2]
            want = jops.spmspm(jA.values, jA.cols, jB.values, jB.cols, K, impl="interpret")
            assert c.work == jref.spmspm_comparisons(jA.cols, jB.cols)
        np.testing.assert_allclose(_np(r.out), np.asarray(want, np.float32), **TOL)


def test_card_sizes_scale_the_reference_benches():
    """CARD keeps the benches' structure (F = 256, the densities, 8x128
    tiles, the five stencils) and only grows R, C, K and the grids."""
    assert sparse_la.CARD.spmm[2] == 256 and sparse_la.BSR_BLOCK == (8, 128)
    assert sparse_la.DENSITIES == (0.0012, 0.01, 0.028) and sparse_la.RIGHT_DENSITY == 0.01
    assert [n for n, _, _ in sparse_la.STENCILS] == ["j2d5pt", "j2d9pt", "j3d7pt",
                                                     "j3d13pt", "j3d27pt"]
    assert [len(o) for _, _, o in sparse_la.STENCILS] == [5, 9, 7, 13, 27]


def test_run_times_each_case_after_one_untimed_call(monkeypatch):
    """``run`` calls every case's op twice, and the record holds the
    second (warm) call's output."""
    cases = sparse_la.make_cases(0, SMALL)
    calls = []
    real = sparse_la.ops.stencil

    def counted(*args, **kw):
        calls.append(args[0].data_ptr())
        return real(*args, **kw) + len(calls)

    monkeypatch.setattr(sparse_la.ops, "stencil", counted)
    stencils = [c for c in cases if c.op == "stencil"]
    runs = sparse_la.run(device="cpu", cases=stencils)
    assert calls == [p for c in stencils for p in [c.args[0].data_ptr()] * 2]
    for i, (r, c) in enumerate(zip(runs, stencils)):
        want = real(*c.args) + 2 * (i + 1)
        torch.testing.assert_close(r.out, want, rtol=0, atol=0)


def test_run_raises_without_cuda_and_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse_la.run(cases=sparse_la.make_cases(0, SMALL))


# ---------------------------------------------------------------------------
# The Hopper kernels (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_sparse_la_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper BSR/SpMSpM/stencil kernels have no CPU mode")
    rng = np.random.default_rng(0)
    A = tsp.random_ell(rng, 64, 512, 0.05)
    bsr = tsp.ell_to_bsr(A, bm=8, bk=128).to("cuda")
    D = torch.from_numpy(rng.standard_normal((512, 300)).astype(np.float32)).cuda()
    torch.testing.assert_close(ops.bsr_spmm(bsr, D, impl="cuda"),
                               ops.bsr_spmm(bsr, D, impl="torch"), **TOL)
    A, B = A.to("cuda"), tsp.random_ell(rng, 70, 512, 0.05).to("cuda")
    torch.testing.assert_close(ops.spmspm(A, B, 512, impl="cuda"),
                               ops.spmspm(A, B, 512, impl="torch"), **TOL)
    # a star on a small grid (the tiled kernel), and y offsets of 40 whose
    # halo outgrows its shared memory (the direct kernel): bitwise equal
    wide = np.array([[0, 0, 0], [1, 40, 0], [-1, -40, 3]])
    for shape, offs in (((16, 12, 10), STAR_R2), ((40, 96, 40), wide)):
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        w = rng.standard_normal(len(offs)).astype(np.float32)
        assert torch.equal(ops.stencil(g, offs, w, impl="cuda"),
                           ops.stencil(g, offs, w, impl="torch"))


# ---------------------------------------------------------------------------
# The BSR kernel's schedule (built by its wrapper in torch, so it runs here)
# and its edge shapes on the card
# ---------------------------------------------------------------------------


def _bsr_layout(name, rng):
    """(tiles (T, bm, bk), rows, cols, num block rows, K, F) of a named
    layout: tiles drawn ~90 % zero."""
    if name == "ell_to_bsr ragged bm=3 bk=20 F=37":
        A = tsp.random_ell(rng, 30, 100, 0.1)
        B = tsp.ell_to_bsr(A, bm=3, bk=20)
        return B.tile_values.numpy(), B.tile_rows.numpy(), B.tile_cols.numpy(), 10, 100, 37
    rows, cols, nr = {
        "empty block rows 1 and 3": ([0, 0, 2, 2], [0, 2, 1, 2], 4),
        "a single tile": ([2], [1], 5),
        "no tiles": ([], [], 3),
        "unsorted columns, a repeated tile": ([0, 1, 1, 1, 1], [1, 2, 0, 2, 1], 2),
    }[name]
    bm, bk, F = 16, 24, 300
    tiles = rng.standard_normal((len(rows), bm, bk)).astype(np.float32)
    tiles[rng.random(tiles.shape) < 0.9] = 0
    return tiles, np.array(rows, np.int32), np.array(cols, np.int32), nr, 3 * bk, F


@pytest.mark.parametrize("name", ["ell_to_bsr ragged bm=3 bk=20 F=37", "empty block rows 1 and 3",
                                  "a single tile", "no tiles", "unsorted columns, a repeated tile"])
def test_bsr_row_pointer_and_plain_path_match_numpy(rng, name):
    """The wrapper's row pointer (each warp's range of tiles) equals
    numpy's from the same tile rows, and the product through the wrapper
    (the plain version, for CPU tensors) equals a numpy construction from
    the same tiles: every tile's product added at its block row, block
    rows without tiles 0."""
    tiles, rows, cols, nr, K, F = _bsr_layout(name, rng)
    bm, bk = tiles.shape[1:] if tiles.size else (16, 24)
    ptr = bsr_wrapper.row_pointer(torch.from_numpy(rows), nr)
    assert ptr.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), np.searchsorted(rows, np.arange(nr + 1), side="left"))
    dense = rng.standard_normal((K, F)).astype(np.float32)
    want = np.zeros((nr * bm, F), np.float64)
    for t in range(len(rows)):
        want[rows[t] * bm:(rows[t] + 1) * bm] += (tiles[t].astype(np.float64)
                                                 @ dense[cols[t] * bk:(cols[t] + 1) * bk])
    tv = torch.from_numpy(tiles.reshape(len(rows), bm, bk))
    got = bsr_wrapper.bsr_spmm_cuda(tv, torch.from_numpy(rows), torch.from_numpy(cols),
                                    torch.from_numpy(dense), nr * bm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for r in set(range(nr)) - set(rows.tolist()):
        assert not got[r * bm:(r + 1) * bm].any()


@pytest.mark.cuda
def test_cuda_bsr_kernel_edge_shapes():
    """The BSR kernel against its plain version at the edge shapes of its
    design: bm 8 / 16 / 3 against its 8-row groups, bk 128 / 20 against
    its 128-column chunks and 16-byte granules, F 256 / 300 against its
    256-column slices, every pair of tile and dense types, a block row
    without tiles (0), and unsorted columns with a repeated tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper BSR kernel has no CPU mode")
    rng = np.random.default_rng(1)
    layouts = [([0, 0, 1, 3, 4, 4, 4], [0, 1, 1, 0, 0, 1, 2]),
               ([0, 0, 1, 4, 4, 4, 4], [2, 0, 1, 1, 2, 0, 2])]
    for bm in (8, 16, 3):
        for bk in (128, 20):
            for F in (256, 300):
                for vt in (torch.float32, torch.bfloat16):
                    for dt in (torch.float32, torch.bfloat16):
                        for rows, cols in layouts:
                            tiles = rng.standard_normal((len(rows), bm, bk)).astype(np.float32)
                            tiles[rng.random(tiles.shape) < 0.9] = 0
                            dense = rng.standard_normal((3 * bk, F)).astype(np.float32)
                            args = (torch.from_numpy(tiles).cuda().to(vt),
                                    torch.tensor(rows, dtype=torch.int32, device="cuda"),
                                    torch.tensor(cols, dtype=torch.int32, device="cuda"),
                                    torch.from_numpy(dense).cuda().to(dt), 5 * bm)
                            got = ops.bsr_spmm(*args, impl="cuda")
                            want = ops.bsr_spmm(*args, impl="torch")
                            torch.testing.assert_close(got, want, **TOL)
                            assert not got[2 * bm:3 * bm].any()


# ---------------------------------------------------------------------------
# The SpMSpM kernel's plan (pure Python) and its edge shapes on the card
# ---------------------------------------------------------------------------

from repro_torch.hopper import spmspm as spmspm_wrapper  # noqa: E402


@pytest.mark.parametrize("C,ct,tiles", [(1, 4, 1), (130, 132, 1), (4096, 4096, 1), (4097, 2052, 2),
                                        (8192, 4096, 2), (9000, 3000, 3), (20000, 4000, 5)])
def test_spmspm_plan_tiles_the_output_columns(C, ct, tiles):
    """One tile where C fits 4096 fp32 sums (16 KB of shared memory a
    warp), else the fewest tiles of even width, rounded up to 4."""
    pl = spmspm_wrapper.plan(7, C, 11, 64)
    assert (pl.ct, pl.tiles) == (ct, tiles)
    assert pl.ct % 4 == 0 and pl.ct <= spmspm_wrapper.CT_MAX and (tiles - 1) * ct < C <= tiles * ct
    assert pl.smem == 4 * spmspm_wrapper.WARPS * ct <= 64 * 1024
    assert pl.grid == -(-7 * tiles // spmspm_wrapper.WARPS)


@pytest.mark.parametrize("R,C,Lb,K", [(4096, 4096, 164, 16384), (7, 50, 200, 40000), (3, 9000, 7, 300),
                                      (1, 5, 0, 10)])
def test_spmspm_scratch_holds_the_copy_of_b(R, C, Lb, K):
    """Counts and offsets per (tile, k), each array rounded up to 4 ints
    (16 bytes), then one (column, value) pair per entry of B."""
    pl = spmspm_wrapper.plan(R, C, Lb, K)
    offsets = pl.tiles * K + 1
    assert pl.scratch == 8 * (-(-offsets // 4) * 4) + 8 * C * Lb
    if (R, C, K) == (4096, 4096, 16384):  # the sparse trio's card size: 5.5 MB
        assert pl.scratch == 5505056


@pytest.mark.cuda
def test_cuda_spmspm_kernel_edge_shapes():
    """The SpMSpM kernel against its plain version: R = 1, a ragged C, C
    wider than one tile, La = 0, Lb = 0, duplicate indices and ELL padding
    in both operands, K = 40000, every pair of value types; indices outside
    [0, K) contribute nothing (held against the plain version on the same
    operands with those entries made padding); a repeated call gives the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper SpMSpM kernel has no CPU mode")
    rng = np.random.default_rng(2)
    cases = [(1, 50, 64, 9, 7), (13, 130, 64, 9, 11), (5, 9000, 300, 20, 7), (4, 7, 10, 0, 5),
             (4, 7, 10, 5, 0), (7, 50, 40000, 300, 200)]
    for R, C, K, La, Lb in cases:
        for at in (torch.float32, torch.bfloat16):
            for bt in (torch.float32, torch.bfloat16):
                a_cols = rng.integers(0, K, (R, La)).astype(np.int32)
                b_rows = rng.integers(0, K, (C, Lb)).astype(np.int32)
                a_vals = rng.standard_normal((R, La)).astype(np.float32)
                b_vals = rng.standard_normal((C, Lb)).astype(np.float32)
                if La:
                    a_vals[:, -1], a_cols[:, -1] = 0, 0  # padding
                    a_cols[0, 0] = K + 3  # out of range
                if Lb:
                    b_vals[:, -1], b_rows[:, -1] = 0, 0
                    b_rows[-1, 0] = -1
                a = (torch.from_numpy(a_vals).cuda().to(at), torch.from_numpy(a_cols).cuda())
                b = (torch.from_numpy(b_vals).cuda().to(bt), torch.from_numpy(b_rows).cuda())
                got = ops.spmspm(*a, *b, K, impl="cuda")
                assert torch.equal(got, ops.spmspm(*a, *b, K, impl="cuda"))
                a_in = (a_cols >= 0) & (a_cols < K)
                b_in = (b_rows >= 0) & (b_rows < K)
                a_p = (torch.from_numpy(np.where(a_in, a_vals, 0)).cuda().to(at),
                       torch.from_numpy(np.where(a_in, a_cols, 0)).cuda())
                b_p = (torch.from_numpy(np.where(b_in, b_vals, 0)).cuda().to(bt),
                       torch.from_numpy(np.where(b_in, b_rows, 0)).cuda())
                want = ops.spmspm(*a_p, *b_p, K, impl="torch")
                torch.testing.assert_close(got, want, **TOL)


def test_spmspm_out_of_range_indices_contribute_nothing():
    """An index outside [0, K) contributes nothing, through the plain
    version (``torch``) and the kernel's wrapper on CPU tensors (``cuda``)
    alike: K = 8, A = [(-1, 1), (3, 2)], B = [(-1, 5), (3, 7)] gives 2 * 7
    with -1 or K + 3 in both, as with those entries removed."""
    K = 8
    for bad in (-1, K + 3):
        a = (torch.tensor([[1.0, 2.0]]), torch.tensor([[bad, 3]], dtype=torch.int32))
        b = (torch.tensor([[5.0, 7.0]]), torch.tensor([[bad, 3]], dtype=torch.int32))
        for impl in ("torch", "cuda"):
            assert ops.spmspm(*a, *b, K, impl=impl).tolist() == [[14.0]]


@pytest.mark.parametrize("seed", [0, 1])
def test_spmspm_out_of_range_entries_equal_their_removal(seed):
    """Random operands with duplicates, padding and entries at -1, -5, K
    and K + 3 in both: ``torch`` and ``cuda`` on CPU tensors agree
    bitwise, and equal the product with those entries made padding."""
    rng = np.random.default_rng(seed)
    R, C, K, La, Lb = 9, 11, 40, 7, 6
    a_cols = rng.integers(0, K, (R, La)).astype(np.int32)
    b_rows = rng.integers(0, K, (C, Lb)).astype(np.int32)
    a_vals = rng.standard_normal((R, La)).astype(np.float32)
    b_vals = rng.standard_normal((C, Lb)).astype(np.float32)
    a_cols[:, 1] = a_cols[:, 0]  # duplicates
    a_vals[:, -1], a_cols[:, -1] = 0, 0  # padding
    for i, bad in enumerate((-1, -5, K, K + 3)):
        a_cols[2 * i, 2] = bad
        b_rows[2 * i + 1, 3] = bad
    a = (torch.from_numpy(a_vals), torch.from_numpy(a_cols))
    b = (torch.from_numpy(b_vals), torch.from_numpy(b_rows))
    got = ops.spmspm(*a, *b, K, impl="torch")
    assert torch.equal(got, ops.spmspm(*a, *b, K, impl="cuda"))
    a_in, b_in = (a_cols >= 0) & (a_cols < K), (b_rows >= 0) & (b_rows < K)
    cleaned = (torch.from_numpy(np.where(a_in, a_vals, 0)), torch.from_numpy(np.where(a_in, a_cols, 0)),
               torch.from_numpy(np.where(b_in, b_vals, 0)), torch.from_numpy(np.where(b_in, b_rows, 0)))
    assert torch.equal(got, ops.spmspm(*cleaned, K, impl="torch"))
    torch.testing.assert_close(got, ops.spmspm(*cleaned, K, impl="ref"), **TOL)


# ---------------------------------------------------------------------------
# The stencil kernel's plan (pure Python) and its edge shapes on the card
# ---------------------------------------------------------------------------

from repro_torch.hopper import stencil as stencil_wrapper  # noqa: E402

SMS = 132  # an H100 SXM
FAR = np.array([[0, 0, 0], [2, -7, 3], [-2, 5, -9], [1, 1, 1]])
WIDE_Y = np.array([[0, 0, 0], [1, 40, 0], [-1, -40, 3], [0, 1, -1]])
X9 = np.array([[9, 0, 0], [-9, 1, 0], [0, 0, 0]])


@pytest.mark.parametrize("shape,offsets,route,tile,runs,grid,smem", [
    ((8192, 8192, 1), sparse_la.star(1, 2), "march", (256, 1), 16, 1024, 36864),
    ((8192, 8192, 1), sparse_la.star(2, 2), "march", (256, 1), 16, 1024, 40960),
    ((512, 512, 512), sparse_la.star(1, 3), "march", (8, 32), 16, 2048, 36864),
    ((512, 512, 512), sparse_la.star(2, 3), "march", (8, 32), 16, 2048, 40960),
    ((512, 512, 512), BOX27, "march", (8, 32), 16, 2048, 36864),
    ((8, 5, 3), BOX27, "march", (85, 3), 1, 1, 36864),
    ((64, 8, 40), X9, "march", (8, 32), 1, 8, 69632),
    ((8, 5, 2), FAR, "direct", None, None, None, 0),
    ((40, 96, 40), WIDE_Y, "direct", None, None, None, 0),
    ((64, 8, 40), np.array([[20, 0, 0], [0, 0, 0]]), "direct", None, None, None, 0),
], ids=["j2d5pt-card", "j2d9pt-card", "j3d7pt-card", "j3d13pt-card", "j3d27pt-card", "box-tiny",
        "x-halo-9", "far-small-z", "y-halo-40", "x-halo-20"])
def test_stencil_plan_routes_and_tiles(shape, offsets, route, tile, runs, grid, smem):
    """The card shapes march 16-plane runs (2-D grids with 256 lanes along
    y, 3-D with 8 x 32 tiles, x cut until the grid has ~8 blocks an SM);
    a halo past 2 cells a thread or a window past ``MAX_SMEM`` takes the
    direct route."""
    q = stencil_wrapper.plan(shape, stencil_wrapper.reduce_offsets(offsets, shape), SMS)
    assert q.route == route and q.smem == smem
    if route == "march":
        assert ((q.ty, q.tz), q.runs, q.grid) == (tile, runs, grid)


@pytest.mark.parametrize("shape", [(8192, 8192, 1), (512, 512, 512), (20, 33, 40), (5, 40, 36),
                                   (100, 20, 33), (64, 48, 1), (16, 40, 24), (48, 9, 64), (1, 1, 1)])
@pytest.mark.parametrize("offsets", [sparse_la.star(1, 2), sparse_la.star(2, 3), BOX27,
                                     np.zeros((0, 3), int)], ids=["star5", "star13", "box27", "none"])
@pytest.mark.parametrize("sms", [1, 132])
def test_stencil_plan_fits_and_covers_the_grid(shape, offsets, sms):
    """A march plan stages at most 2 cells a thread, fits its window in
    ``MAX_SMEM``, and its blocks cover every (tile, run) once: tiles x
    ceil(runs / runs a block) blocks, the last x chunk not empty."""
    red = stencil_wrapper.reduce_offsets(offsets, shape)
    q = stencil_wrapper.plan(shape, red, sms)
    X, Y, Z = shape
    if q.route == "direct":
        return
    rx, ry, rz = (int(np.abs(red[:, a]).max(initial=0)) for a in range(3))
    threads = q.ty * q.tz
    assert threads <= stencil_wrapper.THREADS and q.tz == min(Z, 32)
    assert (q.ty + 2 * ry) * (q.tz + 2 * rz) <= stencil_wrapper.CELLS_PER_THREAD * threads
    assert q.smem == 4 * stencil_wrapper.PITCH * (stencil_wrapper.XR + 2 * rx)
    assert q.smem <= stencil_wrapper.MAX_SMEM
    tiles = -(-Y // q.ty) * -(-Z // q.tz)
    nruns = -(-X // stencil_wrapper.XR)
    chunks = q.grid // tiles
    assert q.grid == tiles * chunks and chunks * q.runs >= nruns > (chunks - 1) * q.runs


@pytest.mark.cuda
def test_cuda_stencil_kernel_edge_shapes():
    """The stencil kernel against its plain version, bitwise, through both
    routes: radius 2 wrapping every face, the box on grids smaller than a
    tile, 2-D grids, bf16, X not a multiple of the 16-plane run (20, 100,
    5), 40 random points, an x halo of 9 (wider than half a run), and
    offsets whose halo outgrows the window (direct); a repeated call gives
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper stencil kernel has no CPU mode")
    rng = np.random.default_rng(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [((16, 12, 10), STAR_R2, torch.float32, None, "march"),
             ((8, 5, 3), BOX27, torch.float32, None, "march"),
             ((64, 48, 1), sparse_la.star(2, 2), torch.float32, None, "march"),
             ((24, 70, 1), sparse_la.star(1, 2), torch.bfloat16, None, "march"),
             ((16, 40, 24), BOX27, torch.bfloat16, None, "march"),
             ((20, 33, 40), BOX27, torch.float32, 4, "march"),
             ((100, 20, 33), STAR_R2, torch.float32, 4, "march"),
             ((5, 40, 36), STAR, torch.float32, None, "march"),
             ((48, 9, 64), rng.integers(-2, 3, (40, 3)), torch.float32, None, "march"),
             ((64, 8, 40), X9, torch.float32, 16, "march"),
             ((8, 5, 2), FAR, torch.float32, None, "direct"),
             ((40, 96, 40), WIDE_Y, torch.bfloat16, None, "direct")]
    for shape, offs, dt, bx, route in cases:
        assert stencil_wrapper.plan(shape, stencil_wrapper.reduce_offsets(offs, shape), sms).route == route
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dt)
        w = rng.standard_normal(len(offs)).astype(np.float32)
        got = ops.stencil(g, offs, w, impl="cuda", bx=bx)
        assert torch.equal(got, ops.stencil(g, offs, w, impl="cuda", bx=bx))
        assert torch.equal(got, ops.stencil(g, offs, w, impl="torch", bx=bx)), (shape, route)
