"""Sparse tensor formats (port of ``repro.core.sparse``, ELL and CSR).

- **ELL** (padded value/index rows): ``values``/``cols`` (R, L) with
  logical shape (R, C). Padding slots carry value 0 and column 0, so they
  add nothing. The spmm path and the GCN run on it.
- **CSR** (compressed rows): the interchange format; ``ell_to_csr`` and
  ``csr_to_ell`` convert between the two.

Construction is host-side and vectorized, with the reference's numpy calls
where the reference uses numpy, so the same seed gives the same matrix.
``EllMatrix`` checks at construction that every column lies in
``[0, C)``: the card's gather reads out of bounds where ``jnp`` clamps, and
this check runs once per matrix, not per launch. Indices are int32, as in
the reference. BSR waits for the ``bsr_spmm`` slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EllMatrix:
    """Padded ELL rows: values/cols (R, L); logical shape (R, C)."""

    values: torch.Tensor
    cols: torch.Tensor
    shape: tuple[int, int]

    def __post_init__(self):
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        R, C = self.shape
        if self.values.dim() != 2 or self.cols.shape != self.values.shape:
            raise ValueError(
                f"EllMatrix: values and cols must both be (R, L), got "
                f"{tuple(self.values.shape)} and {tuple(self.cols.shape)}"
            )
        if self.values.shape[0] != R:
            raise ValueError(f"EllMatrix: {self.values.shape[0]} rows for shape {self.shape}")
        if self.cols.dtype != torch.int32:
            raise TypeError(f"EllMatrix: cols must be int32, got {self.cols.dtype}")
        if self.cols.numel():
            lo, hi = int(self.cols.min()), int(self.cols.max())
            if lo < 0 or hi >= C:
                raise ValueError(
                    f"EllMatrix: column indices span [{lo}, {hi}], outside "
                    f"[0, {C}) for shape {self.shape}"
                )

    @property
    def nnz(self) -> int:
        return int((self.values != 0).sum())

    def todense(self) -> torch.Tensor:
        R, C = self.shape
        rows = torch.arange(R, device=self.values.device)[:, None].expand_as(self.cols)
        out = torch.zeros((R, C), dtype=self.values.dtype, device=self.values.device)
        # padding slots carry value 0, so aliased (row, 0) scatters add nothing
        return out.index_put_((rows, self.cols.long()), self.values, accumulate=True)

    def to(self, device) -> EllMatrix:
        return EllMatrix(self.values.to(device), self.cols.to(device), self.shape)


def dense_to_ell(dense, max_nnz: int | None = None) -> EllMatrix:
    if not isinstance(dense, torch.Tensor):
        dense = torch.from_numpy(np.asarray(dense))
    R, C = dense.shape
    mask = dense != 0
    row_nnz = mask.sum(dim=1)
    most = int(row_nnz.max()) if R else 0
    if max_nnz is not None and most > max_nnz:
        offender = int(row_nnz.argmax())
        raise ValueError(
            f"dense_to_ell: row {offender} has {int(row_nnz[offender])} "
            f"nonzeros > max_nnz={max_nnz}; widen max_nnz or pre-prune"
        )
    L = max_nnz or max(most, 1)
    # stable sort moves nonzero slots to the front, preserving column order
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, : min(L, C)]
    keep = torch.take_along_dim(mask, order, dim=1)
    values = torch.where(keep, torch.take_along_dim(dense, order, dim=1), 0).to(dense.dtype)
    cols = torch.where(keep, order, 0).to(torch.int32)
    if L > C:  # honor a requested slot width wider than the matrix
        values = torch.nn.functional.pad(values, (0, L - C))
        cols = torch.nn.functional.pad(cols, (0, L - C))
    return EllMatrix(values, cols, (R, C))


def random_ell(
    rng: np.random.Generator, R: int, C: int, density: float, dtype=np.float32
) -> EllMatrix:
    """Unstructured random sparse matrix, drawn from a numpy ``Generator``
    with the reference's calls: the same seed gives the same matrix."""
    L = max(int(round(C * density)), 1)
    # row-wise sample-without-replacement: argpartition of uniform keys (O(RC),
    # vs the full-sort O(RC log C)) then sort only the kept L columns
    keys = rng.random((R, C))
    cols = np.sort(
        np.argpartition(keys, L - 1, axis=1)[:, :L].astype(np.int32), axis=1
    )
    values = rng.standard_normal((R, L)).astype(dtype)
    return EllMatrix(torch.from_numpy(values), torch.from_numpy(cols), (R, C))


@dataclasses.dataclass
class CsrMatrix:
    """Compressed sparse rows: data/indices (nnz,), indptr (R+1,)."""

    data: torch.Tensor
    indices: torch.Tensor  # int32 column ids
    indptr: torch.Tensor  # int32 row pointers
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def todense(self) -> torch.Tensor:
        R, C = self.shape
        nnz = self.data.shape[0]
        pos = torch.arange(nnz, dtype=self.indptr.dtype, device=self.indptr.device)
        rows = torch.searchsorted(self.indptr, pos, right=True) - 1
        out = torch.zeros((R, C), dtype=self.data.dtype, device=self.data.device)
        return out.index_put_((rows.long(), self.indices.long()), self.data, accumulate=True)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dense_to_csr(dense) -> CsrMatrix:
    dense = _np(dense)
    R, C = dense.shape
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(R + 1, np.int32)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=R))
    return CsrMatrix(
        torch.from_numpy(dense[rows, cols]),
        torch.from_numpy(cols.astype(np.int32)),
        torch.from_numpy(indptr),
        (R, C),
    )


# ---------------------------------------------------------------------------
# Conversion path: CSR <-> ELL
# ---------------------------------------------------------------------------


def ell_to_csr(A: EllMatrix) -> CsrMatrix:
    vals = _np(A.values)
    cols = _np(A.cols)
    mask = vals != 0  # padding slots carry value 0
    rows, slots = np.nonzero(mask)  # row-major: real entries in column order
    R = A.shape[0]
    indptr = np.zeros(R + 1, np.int32)
    indptr[1:] = np.cumsum(mask.sum(axis=1))
    return CsrMatrix(
        torch.from_numpy(vals[rows, slots]),
        torch.from_numpy(cols[rows, slots].astype(np.int32)),
        torch.from_numpy(indptr),
        A.shape,
    )


def csr_to_ell(A: CsrMatrix, max_nnz: int | None = None) -> EllMatrix:
    data = _np(A.data)
    indices = _np(A.indices)
    indptr = _np(A.indptr)
    R = A.shape[0]
    counts = np.diff(indptr)
    if max_nnz is not None and counts.max(initial=0) > max_nnz:
        offender = int(counts.argmax())
        raise ValueError(
            f"csr_to_ell: row {offender} has {int(counts[offender])} "
            f"nonzeros > max_nnz={max_nnz}; widen max_nnz or pre-prune"
        )
    L = max_nnz or max(int(counts.max(initial=0)), 1)
    rows = np.repeat(np.arange(R), counts)
    slots = np.arange(len(data)) - indptr[rows]  # position within each row
    values = np.zeros((R, L), data.dtype)
    cols = np.zeros((R, L), np.int32)
    values[rows, slots] = data
    cols[rows, slots] = indices
    return EllMatrix(torch.from_numpy(values), torch.from_numpy(cols), A.shape)
