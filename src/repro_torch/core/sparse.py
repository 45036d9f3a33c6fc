"""Sparse tensor formats (port of ``repro.core.sparse``: ELL, BSR, CSR).

- **ELL** (padded value/index rows): ``values``/``cols`` (R, L) with
  logical shape (R, C). Padding slots carry value 0 and column 0, so they
  add nothing. The spmm and spmspm paths and the GCN run on it.
- **BSR** (block-sparse rows): nonzero (bm, bk) tiles sorted by (row,
  col) tile coordinate; every row-block owns at least one tile (an empty
  row-block gets a zero tile), as the reference's constructors guarantee.
  ``bsr_spmm`` runs on it.
- **CSR** (compressed rows): the interchange format; ``ell_to_csr``,
  ``csr_to_ell``, ``csr_to_bsr`` and ``bsr_to_csr`` convert between them.

Construction is host-side and vectorized, with the reference's numpy calls
where the reference uses numpy, so the same seed gives the same matrix.
``EllMatrix`` checks at construction that every column lies in
``[0, C)``, and ``BsrMatrix`` that its tile rows are sorted and its tile
coordinates lie inside the block grid: the card's gathers read out of
bounds where ``jnp`` clamps, and these checks run once per matrix, not per
launch. Indices are int32, as in the reference.
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


# ---------------------------------------------------------------------------
# BSR: block-sparse rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BsrMatrix:
    """Block-sparse rows: tiles (T, bm, bk) sorted by (row, col) tile
    coordinate; logical shape (R, C) with R % bm == C % bk == 0."""

    tile_values: torch.Tensor  # (T, bm, bk)
    tile_rows: torch.Tensor  # (T,) int32 block-row index, sorted
    tile_cols: torch.Tensor  # (T,) int32 block-col index
    shape: tuple[int, int]

    def __post_init__(self):
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        R, C = self.shape
        T = self.tile_values.shape[0] if self.tile_values.dim() == 3 else -1
        if T < 0 or self.tile_rows.shape != (T,) or self.tile_cols.shape != (T,):
            raise ValueError(
                f"BsrMatrix: tile_values (T, bm, bk) and tile_rows/tile_cols "
                f"(T,), got {tuple(self.tile_values.shape)}, "
                f"{tuple(self.tile_rows.shape)}, {tuple(self.tile_cols.shape)}"
            )
        if self.tile_rows.dtype != torch.int32 or self.tile_cols.dtype != torch.int32:
            raise TypeError(
                f"BsrMatrix: tile_rows/tile_cols must be int32, got "
                f"{self.tile_rows.dtype}/{self.tile_cols.dtype}"
            )
        bm, bk = self.block_shape
        _grid_check("BsrMatrix", R, C, bm, bk)
        if T:
            rows, cols = self.tile_rows, self.tile_cols
            if bool((rows[1:] < rows[:-1]).any()):
                raise ValueError("BsrMatrix: tile_rows must be sorted")
            for name, idx, n in (("tile_rows", rows, R // bm), ("tile_cols", cols, C // bk)):
                lo, hi = int(idx.min()), int(idx.max())
                if lo < 0 or hi >= n:
                    raise ValueError(
                        f"BsrMatrix: {name} span [{lo}, {hi}], outside [0, {n}) "
                        f"for shape {self.shape} in {bm}x{bk} tiles"
                    )

    @property
    def block_shape(self) -> tuple[int, int]:
        return int(self.tile_values.shape[1]), int(self.tile_values.shape[2])

    @property
    def density(self) -> float:
        """Share of the (R/bm) x (C/bk) tile grid that is stored."""
        bm, bk = self.block_shape
        total = (self.shape[0] // bm) * (self.shape[1] // bk)
        return len(self.tile_rows) / max(total, 1)

    def todense(self) -> torch.Tensor:
        bm, bk = self.block_shape
        R, C = self.shape
        nr, nc = R // bm, C // bk
        blocked = torch.zeros((nr, nc, bm, bk), dtype=self.tile_values.dtype,
                              device=self.tile_values.device)
        blocked.index_put_((self.tile_rows.long(), self.tile_cols.long()),
                           self.tile_values, accumulate=True)
        return blocked.transpose(1, 2).reshape(R, C)

    def to(self, device) -> BsrMatrix:
        return BsrMatrix(self.tile_values.to(device), self.tile_rows.to(device),
                         self.tile_cols.to(device), self.shape)


def _grid_check(fn, R, C, bm, bk):
    if bm < 1 or bk < 1 or R % bm or C % bk:
        raise ValueError(f"{fn}: shape ({R}, {C}) is not a grid of {bm}x{bk} tiles")


def dense_to_bsr(dense, bm: int = 8, bk: int = 128) -> BsrMatrix:
    dense = _np(dense)
    R, C = dense.shape
    _grid_check("dense_to_bsr", R, C, bm, bk)
    nr, nc = R // bm, C // bk
    blocked = dense.reshape(nr, bm, nc, bk).transpose(0, 2, 1, 3)
    nz = np.any(blocked != 0, axis=(2, 3))  # (nr, nc)
    nz[~nz.any(axis=1), 0] = True  # keep every output row-block initialized
    rows, cols = np.nonzero(nz)  # row-major => sorted by (row, col)
    return BsrMatrix(
        torch.from_numpy(np.ascontiguousarray(blocked[rows, cols])),
        torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(cols.astype(np.int32)),
        (R, C),
    )


def csr_to_bsr(A: CsrMatrix, bm: int = 8, bk: int = 128) -> BsrMatrix:
    """O(nnz) tile build: scatter entries into their (block-row, block-col)
    tiles without materializing the dense matrix."""
    data = _np(A.data)
    indices = _np(A.indices)
    indptr = _np(A.indptr)
    R, C = A.shape
    _grid_check("csr_to_bsr", R, C, bm, bk)
    nr, nc = R // bm, C // bk
    rows = np.repeat(np.arange(R), np.diff(indptr))
    keys = (rows // bm).astype(np.int64) * nc + indices // bk
    # every row-block owns >= 1 tile: add an empty (r, 0) tile where absent
    present = np.zeros(nr, bool)
    present[rows // bm] = True
    empty_keys = np.flatnonzero(~present).astype(np.int64) * nc
    uniq, inv = np.unique(np.concatenate([keys, empty_keys]), return_inverse=True)
    tiles = np.zeros((len(uniq), bm, bk), data.dtype)
    np.add.at(tiles, (inv[: len(keys)], rows % bm, indices % bk), data)
    return BsrMatrix(
        torch.from_numpy(tiles),
        torch.from_numpy((uniq // nc).astype(np.int32)),
        torch.from_numpy((uniq % nc).astype(np.int32)),
        (R, C),
    )


def bsr_to_csr(A: BsrMatrix) -> CsrMatrix:
    """O(tile storage): enumerate nonzero tile entries, never densify."""
    tv = _np(A.tile_values)
    tr = _np(A.tile_rows)
    tc = _np(A.tile_cols)
    T, bm, bk = tv.shape
    R, C = A.shape
    t_idx, r_off, c_off = np.nonzero(tv)
    rows = tr[t_idx] * bm + r_off
    cols = tc[t_idx] * bk + c_off
    order = np.lexsort((cols, rows))  # CSR wants row-major, cols ascending
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(R + 1, np.int32)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=R))
    return CsrMatrix(
        torch.from_numpy(tv[t_idx, r_off, c_off][order]),
        torch.from_numpy(cols.astype(np.int32)),
        torch.from_numpy(indptr),
        (R, C),
    )


def ell_to_bsr(A: EllMatrix, bm: int = 8, bk: int = 128) -> BsrMatrix:
    return csr_to_bsr(ell_to_csr(A), bm=bm, bk=bk)


def bsr_to_ell(A: BsrMatrix, max_nnz: int | None = None) -> EllMatrix:
    return csr_to_ell(bsr_to_csr(A), max_nnz=max_nnz)
