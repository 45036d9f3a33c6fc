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
