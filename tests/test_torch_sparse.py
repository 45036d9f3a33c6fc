"""Port sparse formats vs the JAX reference on the CPU.

``repro_torch.core.sparse`` builds ELL and CSR matrices with the
reference's numpy calls, so the same seed and the same dense input give
the same arrays, bitwise: ``random_ell``, ``dense_to_ell`` (with its
``max_nnz`` raise), ``dense_to_csr``, ``ell_to_csr``, ``csr_to_ell``,
``todense`` and ``nnz``. The port's ``EllMatrix`` also rejects column
indices outside ``[0, C)`` at construction, which the reference leaves to
``jnp``'s clamping.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparse as jsp  # noqa: E402
from repro_torch.core import sparse as tsp  # noqa: E402

SHAPES = [(64, 96, 0.1), (128, 256, 0.02), (30, 50, 0.3)]


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


def _same_ell(got, want):
    _same(got.values, want.values)
    _same(got.cols, want.cols)
    assert got.shape == tuple(want.shape)


def _same_csr(got, want):
    for name in ("data", "indices", "indptr"):
        _same(getattr(got, name), getattr(want, name))
    assert got.shape == tuple(want.shape)


def _sparse_dense(rng, r, c, density):
    dense = rng.standard_normal((r, c)).astype(np.float32)
    dense[rng.random((r, c)) >= density] = 0
    return dense


@pytest.mark.parametrize("r,c,density", SHAPES)
def test_random_ell_matches_jax_for_the_same_seed(r, c, density):
    got = tsp.random_ell(np.random.default_rng(7), r, c, density)
    want = jsp.random_ell(np.random.default_rng(7), r, c, density)
    _same_ell(got, want)
    assert got.nnz == want.nnz
    _same(got.todense(), want.todense())


@pytest.mark.parametrize("max_nnz", [None, 12, 40])
@pytest.mark.parametrize("r,c,density", SHAPES)
def test_dense_to_ell_and_csr_round_trip_match_jax(rng, r, c, density, max_nnz):
    dense = _sparse_dense(rng, r, c, density)
    if max_nnz is not None and (dense != 0).sum(axis=1).max() > max_nnz:
        max_nnz = int((dense != 0).sum(axis=1).max()) + 3
    got = tsp.dense_to_ell(torch.from_numpy(dense), max_nnz)
    want = jsp.dense_to_ell(jnp.asarray(dense), max_nnz)
    _same_ell(got, want)
    _same(got.todense(), want.todense())
    got_csr, want_csr = tsp.ell_to_csr(got), jsp.ell_to_csr(want)
    _same_csr(got_csr, want_csr)
    _same(got_csr.todense(), want_csr.todense())
    _same_csr(tsp.dense_to_csr(dense), jsp.dense_to_csr(dense))
    _same_ell(tsp.csr_to_ell(got_csr, max_nnz), jsp.csr_to_ell(want_csr, max_nnz))
    assert got_csr.nnz == want_csr.nnz == got.nnz


def test_max_nnz_too_narrow_raises_the_reference_message(rng):
    dense = _sparse_dense(rng, 20, 30, 0.5)
    most = int((dense != 0).sum(axis=1).max())
    with pytest.raises(ValueError) as want:
        jsp.dense_to_ell(jnp.asarray(dense), most - 1)
    with pytest.raises(ValueError, match="widen max_nnz") as got:
        tsp.dense_to_ell(torch.from_numpy(dense), most - 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jsp.csr_to_ell(jsp.dense_to_csr(dense), most - 1)
    with pytest.raises(ValueError, match="widen max_nnz") as got:
        tsp.csr_to_ell(tsp.dense_to_csr(dense), most - 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [-1, 50])
def test_ell_rejects_out_of_range_columns_at_construction(bad):
    values = torch.ones((4, 3))
    cols = torch.zeros((4, 3), dtype=torch.int32)
    cols[2, 1] = bad
    with pytest.raises(ValueError, match=r"outside \[0, 50\)"):
        tsp.EllMatrix(values, cols, (4, 50))


def test_ell_checks_shapes_dtypes_and_moves_between_devices():
    values = torch.ones((4, 3))
    cols = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tsp.EllMatrix(values, cols.long(), (4, 5))
    with pytest.raises(ValueError, match="rows"):
        tsp.EllMatrix(values, cols, (5, 5))
    with pytest.raises(ValueError, match=r"\(R, L\)"):
        tsp.EllMatrix(values, cols[:, :2], (4, 5))
    A = tsp.EllMatrix(values, cols, (4, 5))
    B = A.to("cpu")
    assert torch.equal(B.values, A.values) and torch.equal(B.cols, A.cols)
    assert B.shape == (4, 5) and B.nnz == 12


# ---------------------------------------------------------------------------
# BSR: the port's constructors against the reference's, bitwise
# ---------------------------------------------------------------------------


def _same_bsr(got, want):
    _same(got.tile_values, want.tile_values)
    _same(got.tile_rows, want.tile_rows)
    _same(got.tile_cols, want.tile_cols)
    assert got.shape == tuple(want.shape)
    assert got.block_shape == tuple(want.block_shape)
    assert got.density == want.density


def _blocky(rng, r, c, density, bm):
    """Sparse dense matrix whose second row-block is all zeros."""
    dense = _sparse_dense(rng, r, c, density)
    dense[bm:2 * bm] = 0
    return dense


@pytest.mark.parametrize("density", [0.05, 0.3])
@pytest.mark.parametrize("bm,bk", [(8, 128), (16, 64)])
def test_dense_to_bsr_matches_jax(rng, bm, bk, density):
    dense = _blocky(rng, 64, 256, density, bm)
    got = tsp.dense_to_bsr(dense, bm=bm, bk=bk)
    want = jsp.dense_to_bsr(dense, bm=bm, bk=bk)
    _same_bsr(got, want)
    _same(got.todense(), want.todense())
    np.testing.assert_array_equal(got.todense().numpy(), dense)
    # the empty row-block owns one zero tile at column 0
    assert (got.tile_rows == 1).sum() == 1 and int(got.tile_cols[got.tile_rows == 1][0]) == 0
    _same_bsr(tsp.dense_to_bsr(torch.from_numpy(dense), bm=bm, bk=bk), want)


@pytest.mark.parametrize("bm,bk", [(8, 128), (16, 64), (4, 32)])
def test_csr_to_bsr_inserts_empty_tiles_like_jax(rng, bm, bk):
    dense = _blocky(rng, 48, 256, 0.03, bm)
    dense[-bm:] = 0  # the last row-block is empty too
    got = tsp.csr_to_bsr(tsp.dense_to_csr(dense), bm=bm, bk=bk)
    want = jsp.csr_to_bsr(jsp.dense_to_csr(dense), bm=bm, bk=bk)
    _same_bsr(got, want)
    _same(got.todense(), want.todense())
    nr = 48 // bm
    assert sorted(set(got.tile_rows.tolist())) == list(range(nr))


@pytest.mark.parametrize("max_nnz", [None, 40])
@pytest.mark.parametrize("r,c,density", [(64, 256, 0.05), (32, 512, 0.01)])
def test_bsr_csr_ell_round_trips_match_jax(r, c, density, max_nnz):
    got_ell = tsp.random_ell(np.random.default_rng(5), r, c, density)
    want_ell = jsp.random_ell(np.random.default_rng(5), r, c, density)
    for bm, bk in ((8, 128), (16, 64)):
        got = tsp.ell_to_bsr(got_ell, bm=bm, bk=bk)
        want = jsp.ell_to_bsr(want_ell, bm=bm, bk=bk)
        _same_bsr(got, want)
        _same_csr(tsp.bsr_to_csr(got), jsp.bsr_to_csr(want))
        _same_ell(tsp.bsr_to_ell(got, max_nnz), jsp.bsr_to_ell(want, max_nnz))
        _same(got.todense(), want_ell.todense())


def test_bsr_checks_at_construction():
    tv = torch.zeros((3, 8, 128))
    rows = torch.tensor([0, 1, 1], dtype=torch.int32)
    cols = torch.tensor([0, 0, 1], dtype=torch.int32)
    A = tsp.BsrMatrix(tv, rows, cols, (16, 256))
    assert A.block_shape == (8, 128) and A.density == 0.75
    with pytest.raises(ValueError, match="sorted"):
        tsp.BsrMatrix(tv, torch.tensor([1, 0, 1], dtype=torch.int32), cols, (16, 256))
    with pytest.raises(ValueError, match=r"tile_cols span \[0, 2\], outside \[0, 2\)"):
        tsp.BsrMatrix(tv, rows, torch.tensor([0, 0, 2], dtype=torch.int32), (16, 256))
    with pytest.raises(ValueError, match=r"tile_rows span \[0, 2\], outside \[0, 2\)"):
        tsp.BsrMatrix(tv, torch.tensor([0, 1, 2], dtype=torch.int32), cols, (16, 256))
    with pytest.raises(ValueError, match="tile_cols span"):
        tsp.BsrMatrix(tv, rows, torch.tensor([0, -1, 1], dtype=torch.int32), (16, 256))
    with pytest.raises(TypeError, match="int32"):
        tsp.BsrMatrix(tv, rows.long(), cols, (16, 256))
    with pytest.raises(ValueError, match="grid of 8x128"):
        tsp.BsrMatrix(tv, rows, cols, (12, 256))
    with pytest.raises(ValueError, match=r"\(T,\)"):
        tsp.BsrMatrix(tv, rows[:2], cols, (16, 256))
    # the reference asserts where the port's constructors raise
    with pytest.raises(AssertionError):
        jsp.dense_to_bsr(np.zeros((12, 256), np.float32))
    with pytest.raises(ValueError, match="grid of 8x128"):
        tsp.dense_to_bsr(np.zeros((12, 256), np.float32))
    with pytest.raises(ValueError, match="grid of 8x128"):
        tsp.csr_to_bsr(tsp.dense_to_csr(np.zeros((16, 200), np.float32)))
    B = A.to("cpu")
    assert torch.equal(B.tile_values, A.tile_values) and B.shape == A.shape
