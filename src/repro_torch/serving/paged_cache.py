"""PagedKVCache: block-table KV storage for the serving engine (port of
``repro.serving.paged_cache``).

Per layer a pool of fixed-size KV pages, ``k_pool``/``v_pool`` shaped
``(nl, P, K, bs, hd)``, addressed through the per-sequence block tables
the scheduler keeps. Page ``NULL_BLOCK`` (0) is the shared scratch page:
inactive decode slots and unwritten table tails point at it, and the
decode mask makes every read of it an exact no-op.

With a ``policy`` (``core.precision``) the pools hold the cache narrow:
values in the policy's compute dtype plus per-row fp32 scales
``k_scale``/``v_scale`` ``(nl, P, K, bs, 1)``, from the per-row
quantization ``precision.quantize_kv_cache`` applies; decode dequantizes
each page at use inside its fp32 online softmax, so the resident cache
shrinks by the width ratio. fp8 pools are written and gathered through
their bytes (``blocked.as_bytes``), which every device's indexing takes.

Unlike the reference's pure updates, writes here are **in place**:
``write_prompt`` and ``restore_blocks`` scatter into the pools (and return
the same cache), and the paged decode step writes each new token's row in
place. ``gather_blocks`` therefore returns a copy on the host: a view of
the pools would be overwritten by later steps and break preempt/resume.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import precision as prec
from repro_torch.device import resolve_device
from repro_torch.hopper.blocked import FP8_DTYPES, as_bytes
from repro_torch.serving.scheduler import NULL_BLOCK  # re-export: table sentinel

__all__ = ["PagedKVCache", "NULL_BLOCK", "init_paged_cache"]


@dataclasses.dataclass
class PagedKVCache:
    """KV page pools (and, with a ``policy``, their scales) for every layer:
    ``k_pool``/``v_pool`` (nl, P, K, bs, hd); ``k_scale``/``v_scale``
    (nl, P, K, bs, 1) fp32 when ``policy`` is set, else None;
    ``block_size`` is the page size ``bs``."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    block_size: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    policy: str | None = None

    @property
    def num_blocks(self) -> int:
        return self.k_pool.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def _ids(self, block_ids):
        return torch.as_tensor(block_ids, dtype=torch.long,
                               device=self.k_pool.device)

    def _tensors(self):
        names = ("k", "v", "k_scale", "v_scale") if self.quantized else ("k", "v")
        pools = (self.k_pool, self.v_pool, self.k_scale, self.v_scale)
        return dict(zip(names, pools))

    def write_prompt(self, block_ids, k_rows, v_rows) -> "PagedKVCache":
        """Scatter a prefilled prompt's KV into pages, in place.
        ``block_ids`` (nbp,) physical pages in logical order;
        ``k_rows``/``v_rows`` (nl, nbp, K, bs, hd), the tail page
        zero-padded (the padding is never unmasked). Under a policy the
        rows are quantized per row first."""
        ids = self._ids(block_ids)
        if self.quantized:
            kq, ks, vq, vs = prec.quantize_kv_cache(k_rows, v_rows, self.policy)
            rows = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            rows = {"k": k_rows, "v": v_rows}
        for name, pool in self._tensors().items():
            as_bytes(pool)[:, ids] = as_bytes(rows[name].to(pool.dtype))
        return self

    def gather_blocks(self, block_ids) -> dict:
        """Host copy of the listed pages (the preemption payload): dict of
        (nl, n, K, bs, hd) CPU tensors, with the (nl, n, K, bs, 1) scales
        when quantized. Round-trips bitwise through ``restore_blocks``."""
        ids = self._ids(block_ids)
        return {name: as_bytes(pool)[:, ids].cpu().view(pool.dtype)
                for name, pool in self._tensors().items()}

    def restore_blocks(self, block_ids, payload) -> "PagedKVCache":
        """Write a ``gather_blocks`` payload into (possibly different)
        physical pages, in place: the resume half of preemption."""
        ids = self._ids(block_ids)
        for name, pool in self._tensors().items():
            as_bytes(pool)[:, ids] = as_bytes(payload[name]).to(pool.device)
        return self


def init_paged_cache(cfg, *, num_blocks: int, block_size: int,
                     policy: str | None = None, device=None,
                     num_layers: int | None = None) -> PagedKVCache:
    """Zero pools sized from the model config on ``device`` (default
    ``cuda``): in its activation dtype, or with a ``policy`` in the
    policy's compute dtype with unit fp32 scales. ``num_layers`` (default
    ``cfg.num_layers``) is the number of layers that keep KV, where some
    layers keep none (a hybrid's recurrent layers)."""
    device = resolve_device(device)
    nl, K = num_layers or cfg.num_layers, cfg.num_kv_heads
    shape = (nl, num_blocks, K, block_size, cfg.resolved_head_dim())
    k_scale = v_scale = None
    if policy is None:
        dtype = getattr(torch, cfg.dtype)
    else:
        dtype = prec.resolve(policy).compute_dtype
        k_scale = torch.ones((*shape[:-1], 1), dtype=torch.float32, device=device)
        v_scale = torch.ones_like(k_scale)

    def zeros():  # fp8 pools are zeroed through their bytes
        raw = torch.uint8 if dtype in FP8_DTYPES else dtype
        return torch.zeros(shape, dtype=raw, device=device).view(dtype)

    return PagedKVCache(
        k_pool=zeros(), v_pool=zeros(),
        block_size=block_size, k_scale=k_scale, v_scale=v_scale, policy=policy,
    )
