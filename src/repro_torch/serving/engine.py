"""Continuous-batching serving engine (port of ``repro.serving.engine``).

Wires the host-side scheduler (``serving/scheduler.py``) to the paged model
step (``models/transformer.decode_step_paged`` over a ``PagedKVCache``).
One ``step()`` is one unit of virtual time, in the reference's order:

  1. admit arrived requests (FCFS within priority class) while a decode
     slot and enough cache blocks exist; each admission runs a prefill
     (per length bucket) and scatters the prompt KV into its pages —
     resumed requests restore their saved pages instead (the preemption
     round-trip is bitwise);
  2. grow each running sequence's block list for the token this step
     writes, preempting victims on exhaustion (their pages are copied to
     the host before the blocks free);
  3. one decode over ALL slots — inactive rows point at the shared scratch
     page and their outputs are dropped;
  4. record tokens, retire on EOS / max-new-tokens, free blocks.

The model half sits behind a small protocol (``prefill``/``decode``/
``save_blocks``/``restore_blocks``), so the scheduler runs against the
host-only ``StubModel`` too. ``PagedModel`` serves the transformer
families the reference's engine serves, dense and MoE, and the port's
granite_hybrid (Mamba-2 and attention layers: KV pages for the attention
layers, a per-slot state pool for the others), on ``device`` (``cuda``
unless the caller passes another); with
``precision=`` its KV pools hold the cache narrow (values plus per-row fp32
scales, dequantized at use in decode); with ``mesh=`` its decode attention
runs as ring decode over the mesh's ``ring_axis`` (``ring_attn_fn``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.hopper import decode_attention
from repro_torch.parallel.mesh import RingMesh
from repro_torch.serving import ring_decode
from repro_torch.serving import scheduler as sched
from repro_torch.serving.scheduler import NULL_BLOCK, Request

__all__ = ["ServingEngine", "PagedModel", "StubModel", "Request"]


class StubModel:
    """Deterministic host-only model stub for scheduler tests.

    Token streams follow a per-sequence integer recurrence seeded by the
    last prompt token, so any slot/cache mix-up between sequences derails
    the stream. ``save/restore`` round-trip a small payload so preemption
    bookkeeping is exercised too.
    """

    def __init__(self, vocab: int = 251):
        self.vocab = vocab

    def _next(self, token: int, position: int) -> int:
        return (token * 31 + position * 7 + 13) % self.vocab

    def prefill(self, seq, block_ids):
        prompt = seq.req.prompt
        return self._next(prompt[-1], len(prompt) - 1)

    def decode(self, slot_tokens, slot_positions, slot_tables, active):
        out = np.zeros(len(slot_tokens), np.int64)
        for i in range(len(slot_tokens)):
            out[i] = self._next(int(slot_tokens[i]), int(slot_positions[i]))
        return out

    def save_blocks(self, seq, block_ids):
        return ("payload", seq.rid, len(block_ids))

    def restore_blocks(self, seq, block_ids, payload):
        tag, rid, n = payload
        if tag != "payload" or rid != seq.rid or n > len(block_ids):
            raise RuntimeError(f"stub payload {payload} does not fit rid {seq.rid}")


def ring_attn_fn(mesh, ring_axis: str = "data"):
    """The paged decode's ``attn_fn`` as ring decode over ``mesh``'s
    ``ring_axis`` (the ranks of its first group; other axes replicate).

    ``ring_decode`` shards the pools by pages and wants each table column's
    entries to index the owning rank's local pool (rank r owns every
    sequence's columns ``[r NB_l, (r + 1) NB_l)``), but the scheduler hands
    out global page ids from one pool. So each call gathers, per rank, the
    pages its columns reference (every row's ``NB_l`` entries, null ones
    included) into that rank's shard of a pool of ``n B NB_l`` pages, and
    passes the local ids ``b NB_l + j``: the contract holds whatever pages
    the allocator chose. (The reference's engine passes the global ids
    through; its gather clamps those past a rank's slab, and its streams
    leave the unsharded engine's.)"""
    ranks = mesh.group(ring_axis, 0)
    ring = RingMesh(len(ranks), devices=[mesh.devices[r] for r in ranks])
    n = ring.n

    def attn_fn(q, kp, vp, ks, vs, tbl, pos, window):
        B, NB = tbl.shape
        nb_l = NB // n
        order = tbl.long().reshape(B, n, nb_l).transpose(0, 1).reshape(-1)
        local = torch.arange(B * nb_l, dtype=tbl.dtype, device=tbl.device).reshape(B, nb_l)
        pools = [None if x is None else x[order] for x in (kp, vp, ks, vs)]
        return ring_decode.ring_decode(q, pools[0], pools[1], local.repeat(1, n), pos, ring,
                                       window=window, k_scale=pools[2], v_scale=pools[3])

    return attn_fn


class PagedModel:
    """The real model half: bucketed paged prefill + all-slot paged decode
    of the dense or MoE transformer, or of the granite_hybrid family, over
    a ``PagedKVCache`` on ``device``; with a ``precision`` policy the pools
    hold the cache quantized per row.

    The family's module gives the model half its interface
    (``paged_layout``, ``paged_prefill``, ``paged_decode``).
    granite_hybrid keeps KV pages for its attention layers only, and beside
    them a state pool indexed by slot (``granite_hybrid.init_state``; a
    transformer's pool is empty): the prefill writes the slot's whole state as it stands after the last real
    prompt token (the bucket's padding leaves it unmoved), each decode
    advances every slot's state in place, and a preempted sequence's state
    goes to the host with its pages and comes back into its new slot.

    The prefill runs on the prompt padded to its block bucket, as the
    reference's does: causal attention keeps the real rows independent of
    the padded tail, but an MoE layer's capacity is computed from the
    padded length and the pad tokens sort after the real ones within each
    expert. Both engines do this, so their MoE streams agree.

    ``mesh`` (a ``DeviceMesh`` with a ``ring_axis``): decode attention runs
    as ring decode over that axis (``ring_attn_fn``); ``num_blocks`` and
    ``max_blocks_per_seq`` must divide by its size, as in the reference.
    The prefill stays unsharded. granite_hybrid decodes on one device."""

    def __init__(self, cfg, params, *, num_blocks, block_size, max_slots,
                 max_blocks_per_seq, precision=None, device=None, mesh=None,
                 ring_axis: str = "data"):
        from repro_torch.models import granite_hybrid, transformer
        from repro_torch.serving import paged_cache

        family = {"dense": transformer, "moe": transformer,
                  "granite_hybrid": granite_hybrid}.get(cfg.family)
        if family is None:
            raise NotImplementedError(
                "PagedModel serves the transformer families (dense, moe) and "
                f"granite_hybrid, got {cfg.family!r}"
            )
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on {self.device}"
            )
        self.family = family
        self.cfg, self.params = cfg, params
        self.block_size = block_size
        self.vocab = cfg.vocab_size
        # the window of each layer that keeps KV, in layer order, and the
        # state pool by slot of the layers that keep a state instead
        self.attention_windows, self.state = family.paged_layout(
            cfg, max_slots, device=self.device)
        self.cache = paged_cache.init_paged_cache(
            cfg, num_blocks=num_blocks, block_size=block_size, device=self.device,
            policy=None if precision is None else getattr(precision, "name", precision),
            num_layers=len(self.attention_windows),
        )
        self.tables = np.full(
            (max_slots, max_blocks_per_seq), NULL_BLOCK, np.int32
        )
        self.attn_fn = None
        if mesh is not None:
            n = mesh.shape[ring_axis]
            if num_blocks % n or max_blocks_per_seq % n:
                raise ValueError(
                    "ring decode needs num_blocks and max_blocks_per_seq "
                    f"divisible by the {ring_axis} axis ({n})"
                )
            self.attn_fn = ring_attn_fn(mesh, ring_axis)

    def _tensor(self, x, dtype=torch.long):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- prefill ------------------------------------------------------------

    def _bucket(self, s0: int) -> int:
        return self.block_size * math.ceil(s0 / self.block_size)

    def prefill(self, seq, block_ids):
        prompt = seq.req.prompt
        sb = self._bucket(len(prompt))
        nbp = sb // self.block_size
        tokens = np.zeros((1, sb), np.int64)
        tokens[0, : len(prompt)] = prompt
        ids = np.full(nbp, NULL_BLOCK, np.int64)
        ids[: len(block_ids)] = block_ids  # prompt pages (the grant covers them)
        # tokens padded to the bucket: causal attention keeps every real
        # row independent of the padded tail, and a recurrent layer's state
        # is taken after the last real token
        last, kv, state = self.family.paged_prefill(
            self.params, self.cfg, self._tensor(tokens), len(prompt))
        if state:
            with tracing.span("engine.state", rid=seq.rid, slot=seq.slot, op="write"):
                for name, pool in self.state.items():  # the slot's whole state: reset and written
                    pool[:, seq.slot].copy_(state[name])
        nl, _, K, _, hd = kv["k"].shape

        def rows(x):  # (nl, 1, K, sb, hd) -> (nl, nbp, K, bs, hd)
            return x[:, 0].reshape(nl, K, nbp, self.block_size, hd).transpose(1, 2)

        self.cache.write_prompt(ids, rows(kv["k"]), rows(kv["v"]))
        first = int(torch.argmax(last[: self.vocab]))
        self.tables[seq.slot, :] = NULL_BLOCK
        self.tables[seq.slot, : len(block_ids)] = block_ids
        return first

    # -- decode -------------------------------------------------------------

    def sync_table(self, seq) -> None:
        """Mirror the scheduler's block list into the slot's table row."""
        self.tables[seq.slot, :] = NULL_BLOCK
        self.tables[seq.slot, : len(seq.blocks)] = seq.blocks

    def decode(self, slot_tokens, slot_positions, slot_tables, active):
        batch = {
            "token": self._tensor(slot_tokens),
            "position": self._tensor(slot_positions),
            "block_table": self._tensor(slot_tables, torch.int32),
        }
        logits, self.cache = self.family.paged_decode(
            self.params, self.cfg, self.cache, batch, self.state, self.attn_fn)
        with tracing.span("decode.fetch"):
            return torch.argmax(logits[:, : self.vocab], dim=-1).cpu().numpy()

    # -- preemption payloads -------------------------------------------------

    def save_blocks(self, seq, block_ids):
        """The sequence's pages on the host and, with a state pool, its
        slot's state beside them."""
        pages = self.cache.gather_blocks(np.asarray(block_ids, np.int64))
        if not self.state:
            return pages
        with tracing.span("engine.state", rid=seq.rid, slot=seq.slot, op="save"):
            return {"pages": pages,
                    "state": {n: pool[:, seq.slot].to("cpu", copy=True)  # not a view
                              for n, pool in self.state.items()}}

    def restore_blocks(self, seq, block_ids, payload):
        if self.state:
            with tracing.span("engine.state", rid=seq.rid, slot=seq.slot, op="restore"):
                for n, pool in self.state.items():
                    pool[:, seq.slot].copy_(payload["state"][n])
            payload = payload["pages"]
        n = payload["k"].shape[1]
        self.cache.restore_blocks(np.asarray(block_ids[:n], np.int64), payload)


class ServingEngine:
    """Open-loop continuous-batching engine over a paged KV cache."""

    def __init__(self, model, *, num_blocks, block_size, max_slots,
                 max_blocks_per_seq, eos_id: int | None = None):
        self.model = model
        self.scheduler = sched.ContinuousBatchingScheduler(
            num_blocks=num_blocks, block_size=block_size,
            max_slots=max_slots, max_blocks_per_seq=max_blocks_per_seq,
        )
        self.max_slots = max_slots
        # decode-table width: with no per-sequence cap, a sequence can at
        # most hold the whole non-null pool
        self.table_width = max_blocks_per_seq or (num_blocks - 1)
        self.eos_id = eos_id
        self.step_count = 0
        self.completed: dict[int, tuple] = {}  # rid -> generated tokens
        self.latency_steps: dict[int, int] = {}  # rid -> retire - arrival
        # snapshot a victim's pages to the host BEFORE the scheduler frees
        # the ledger entries (the resume half restores them bitwise)
        orig_preempt = self.scheduler.preempt

        def _preempt(seq, step):
            seq.saved_payload = self.model.save_blocks(seq, list(seq.blocks))
            orig_preempt(seq, step)

        self.scheduler.preempt = _preempt

    @classmethod
    def with_model(cls, cfg, params, *, num_blocks=64, block_size=16,
                   max_slots=8, max_blocks_per_seq=16, precision=None,
                   device=None, mesh=None, eos_id=None):
        """An engine over a ``PagedModel`` of ``cfg``/``params`` on
        ``device`` (default ``cuda``; raises without CUDA unless a device
        is given); ``precision`` holds its KV pools narrow, ``mesh`` runs
        its decode attention as ring decode over ``data``."""
        model = PagedModel(
            cfg, params, num_blocks=num_blocks, block_size=block_size,
            max_slots=max_slots, max_blocks_per_seq=max_blocks_per_seq,
            precision=precision, device=device, mesh=mesh,
        )
        return cls(model, num_blocks=num_blocks, block_size=block_size,
                   max_slots=max_slots, max_blocks_per_seq=max_blocks_per_seq,
                   eos_id=eos_id)

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    # -- one step of virtual time -------------------------------------------

    def step(self) -> int:
        """Admissions + one decode over all slots. Returns the number of
        live tokens produced this step."""
        with tracing.span("engine.step", step=self.step_count):
            return self._step()

    def _step(self) -> int:
        s = self.step_count
        sc = self.scheduler

        for seq in sc.admit(s):
            if seq.saved_payload is not None:  # resume: restore pages
                self.model.restore_blocks(seq, seq.blocks, seq.saved_payload)
                seq.saved_payload = None
                if hasattr(self.model, "sync_table"):
                    self.model.sync_table(seq)
            else:
                with tracing.span("engine.prefill", rid=seq.rid):
                    first = self.model.prefill(seq, seq.blocks)
                sc.record_token(seq, first)
                if sc.should_retire(seq, self.eos_id):
                    self._retire(seq, s)

        # grow blocks (preempting on exhaustion) for this step's writes
        for slot in sorted(self.scheduler.running):
            seq = self.scheduler.running.get(slot)
            if seq is None:  # already preempted as someone's victim
                continue
            before = len(seq.blocks)
            if not sc.ensure_block(seq, s):
                continue  # preempted itself; decode next round
            if len(seq.blocks) != before and hasattr(self.model, "sync_table"):
                self.model.sync_table(seq)

        produced = 0
        if self.scheduler.running:
            tokens = np.zeros(self.max_slots, np.int64)
            positions = np.zeros(self.max_slots, np.int64)
            tables = np.full(
                (self.max_slots, self.table_width), NULL_BLOCK, np.int32,
            )
            if hasattr(self.model, "tables"):
                tables = self.model.tables
                tables[:] = NULL_BLOCK
            active = np.zeros(self.max_slots, bool)
            live = dict(self.scheduler.running)
            for slot, seq in live.items():
                active[slot] = True
                tokens[slot] = seq.generated[-1]
                positions[slot] = seq.next_position()
                tables[slot, : len(seq.blocks)] = seq.blocks
            pages = self._pages(positions, active, tables) if tracing.live() else {}
            with tracing.span("engine.decode", **pages):
                next_tokens = self.model.decode(tokens, positions, tables, active)
            for slot, seq in live.items():
                sc.record_token(seq, int(next_tokens[slot]))
                produced += 1
                if sc.should_retire(seq, self.eos_id):
                    self._retire(seq, s)

        self.step_count += 1
        return produced

    def _pages(self, positions, active, tables) -> dict:
        """The decode's page counters over the layers that keep KV: the
        active slots' pages up to the position each writes
        (``pages_live``), and the pages the resolved decode attention walks
        (``pages_walked``): the kernel the live pages of each slot in the
        window of each layer, an idle one's scratch page included
        (``decode_attention.live_pages``), the plain form every table
        column of every slot. With a state pool, the slot states the step
        reads and writes (``state_rows``, every slot's) and the active
        slots' among them (``state_live``)."""
        bs = self.scheduler.block_size
        windows = getattr(self.model, "attention_windows", None)
        if windows is None:  # a model that names no windows: its config's, every layer
            cfg = getattr(self.model, "cfg", None)
            windows = ((getattr(cfg, "sliding_window", 0) or 0),) * getattr(cfg, "num_layers", 1)
        live = int(((positions[active] + bs) // bs).sum()) * len(windows)
        walked = tables.size * len(windows)
        if decode_attention.walks_live_pages(getattr(self.model, "device", "cpu")):
            walked = sum(int(decode_attention.live_pages(positions, bs=bs, nb=tables.shape[1],
                                                         window=w).sum()) * windows.count(w)
                         for w in set(windows))
        out = {"pages_live": live, "pages_walked": walked}
        if getattr(self.model, "state", None):
            out.update(state_live=int(active.sum()), state_rows=len(active))
        return out

    def _retire(self, seq, step: int) -> None:
        self.scheduler.retire(seq, step)
        self.completed[seq.rid] = tuple(seq.generated)
        self.latency_steps[seq.rid] = step - seq.req.arrival + 1

    def run(self, max_steps: int = 10_000) -> dict:
        while not self.scheduler.idle():
            if self.step_count >= max_steps:
                raise RuntimeError(
                    f"engine did not drain in {max_steps} steps "
                    f"(running={sorted(s.rid for s in self.scheduler.running.values())})"
                )
            self.step()
        return dict(self.completed)

    def leaked_blocks(self) -> int:
        return self.scheduler.leaked_blocks()
