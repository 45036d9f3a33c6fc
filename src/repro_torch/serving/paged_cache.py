"""PagedKVCache: block-table KV storage for the serving engine (port of
``repro.serving.paged_cache``, full-precision pools).

Per layer a pool of fixed-size KV pages, ``k_pool``/``v_pool`` shaped
``(nl, P, K, bs, hd)``, addressed through the per-sequence block tables
the scheduler keeps. Page ``NULL_BLOCK`` (0) is the shared scratch page:
inactive decode slots and unwritten table tails point at it, and the
decode mask makes every read of it an exact no-op.

Unlike the reference's pure updates, writes here are **in place**:
``write_prompt`` and ``restore_blocks`` scatter into the pools (and return
the same cache), and the paged decode step writes each new token's row in
place. ``gather_blocks`` therefore returns a copy on the host: a view of
the pools would be overwritten by later steps and break preempt/resume.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.scheduler import NULL_BLOCK  # re-export: table sentinel

__all__ = ["PagedKVCache", "NULL_BLOCK", "init_paged_cache"]


@dataclasses.dataclass
class PagedKVCache:
    """KV page pools for every layer: ``k_pool``/``v_pool`` (nl, P, K, bs,
    hd); ``block_size`` is the page size ``bs``."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    block_size: int

    def _ids(self, block_ids):
        return torch.as_tensor(block_ids, dtype=torch.long,
                               device=self.k_pool.device)

    def write_prompt(self, block_ids, k_rows, v_rows) -> "PagedKVCache":
        """Scatter a prefilled prompt's KV into pages, in place.
        ``block_ids`` (nbp,) physical pages in logical order;
        ``k_rows``/``v_rows`` (nl, nbp, K, bs, hd), the tail page
        zero-padded (the padding is never unmasked)."""
        ids = self._ids(block_ids)
        self.k_pool[:, ids] = k_rows.to(self.k_pool.dtype)
        self.v_pool[:, ids] = v_rows.to(self.v_pool.dtype)
        return self

    def gather_blocks(self, block_ids) -> dict:
        """Host copy of the listed pages (the preemption payload): dict of
        (nl, n, K, bs, hd) CPU tensors. Round-trips bitwise through
        ``restore_blocks``."""
        ids = self._ids(block_ids)
        return {"k": self.k_pool[:, ids].cpu(), "v": self.v_pool[:, ids].cpu()}

    def restore_blocks(self, block_ids, payload) -> "PagedKVCache":
        """Write a ``gather_blocks`` payload into (possibly different)
        physical pages, in place: the resume half of preemption."""
        ids = self._ids(block_ids)
        self.k_pool[:, ids] = payload["k"].to(self.k_pool.device)
        self.v_pool[:, ids] = payload["v"].to(self.v_pool.device)
        return self


def init_paged_cache(cfg, *, num_blocks: int, block_size: int,
                     device=None) -> PagedKVCache:
    """Zero pools sized from the model config, in its activation dtype, on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
             cfg.resolved_head_dim())
    dtype = getattr(torch, cfg.dtype)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=dtype, device=device),
        v_pool=torch.zeros(shape, dtype=dtype, device=device),
        block_size=block_size,
    )
