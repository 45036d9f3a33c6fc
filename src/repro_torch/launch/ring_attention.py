"""The sequence-parallel ring on the card, at occamy-gptj's attention width.

    python -m repro_torch.launch.ring_attention [--device cpu] [--n 4] [--small]

The port's twin of ``benchmarks/bench_mesh.py``'s ``flash_attention_long``
and ``mesh_overlap_*`` rows and of ``benchmarks/bench_d2d.py``'s Fig. 13b
transfer-size sweep, on a single-controller ``RingMesh`` of ``n`` ranks
(each rank on its own stream; on one card all ranks share it):

- **hop sweep**: one ring hop (``hopper/ring_hop.py``) against ``copy_``
  of the same bytes, per transfer size: bitwise, then timed cold (the
  card's L2 flushed before each call) and warm (back to back);
- **flash ring**: ``ops.flash_attention(q, k, v, mesh=RingMesh(n),
  remote_copy=True)`` per case (zigzag, contiguous and windowed rings, and
  a batch split), with ``overlap`` on and off and ``remote_copy`` off,
  against the unsharded call;
- **ring decode**: ``serving.ring_decode.ring_decode`` over pools sharded
  on the ring (bf16 or fp32 pools, and fp8 e4m3 pools with their scales),
  against ``ring_decode_reference`` and contiguous decode.

``run`` returns the rows; each names the device it ran on, and counts the
calls it made of each ring variant (``calls``), so that a caller can hold
the kernel launch counts of a whole run to the per-call counts. On the
card times come from CUDA events on the caller's stream, which the ring's
streams join at the end of each call; on the CPU they are host-clock
times of the plain routes and say nothing of the card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time

import torch

from repro_torch.core import precision as prec
from repro_torch.device import resolve_device
from repro_torch.hopper import dispatch, ops, partition, ring_hop
from repro_torch.parallel.mesh import RingMesh
from repro_torch.serving.ring_decode import ring_decode, ring_decode_reference

@dataclasses.dataclass(frozen=True)
class Cases:
    """One size of the run. ``hop_bytes``: the hop sweep's transfer
    sizes; ``heads`` / ``kv_heads`` / ``head_dim`` / ``dtype``: the
    attention width; ``flash``: (label, B, S, causal, window, zigzag) per
    flash case; ``decode_batch`` / ``decode_cols`` / ``block_size``: ring
    decode's batch, table columns and page size; ``iters``: timed calls per
    measurement."""

    hop_bytes: tuple
    heads: int
    kv_heads: int
    head_dim: int
    dtype: str
    flash: tuple
    decode_batch: int
    decode_cols: int
    block_size: int
    iters: int
    hop_iters: int


# occamy-gptj's attention (16 heads x 256, bf16); S = 2048 is GPT-J's
# context and S = 16384 the long-context case of flash_attention_long; the
# hop sweep is Fig. 13b's latency-to-bandwidth curve, 4 MiB being the K
# chunk of the S = 2048 ring at n = 4
CARD = Cases(
    hop_bytes=(16 << 10, 256 << 10, 4 << 20, 64 << 20),
    heads=16, kv_heads=16, head_dim=256, dtype="bfloat16",
    flash=tuple(
        [(f"S={S} causal zigzag", 1, S, True, 0, True) for S in (2048, 16384)]
        + [(f"S={S} causal contiguous", 1, S, True, 0, False) for S in (2048, 16384)]
        + [(f"S={S} window 512", 1, S, True, 512, True) for S in (2048, 16384)]
        + [("B=4 S=2048 batch split", 4, 2048, True, 0, True)]
    ),
    decode_batch=4, decode_cols=128, block_size=16, iters=5, hop_iters=20,
)
SMALL = Cases(
    hop_bytes=(16, 1000, 4096),
    heads=4, kv_heads=2, head_dim=16, dtype="float32",
    flash=(("S=64 causal zigzag", 1, 64, True, 0, True),
           ("S=64 causal contiguous", 1, 64, True, 0, False),
           ("S=64 window 12", 1, 64, True, 12, True),
           ("S=64 non-causal", 1, 64, False, 0, True),
           ("B=4 S=32 batch split", 4, 32, True, 0, True)),
    decode_batch=3, decode_cols=8, block_size=8, iters=2, hop_iters=2,
)


# written between two cold hops: five times the card's 50 MB L2, so that
# each hop reads its source from HBM
FLUSH_BYTES = 256 << 20


class _CallCount:
    """``fn`` with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self):
        self.calls += 1
        return self.fn()


def _timer(device, iters):
    """``time(fn)``: mean ms per call over ``iters`` calls after a warm-up
    call; CUDA events on the card, the host clock on the CPU."""
    def cuda_time(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_time(fn):
        fn()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters

    return cuda_time if device.type == "cuda" else host_time


def _cold_timer(device, iters):
    """``time(fn)``: mean ms of one call of ``fn`` over ``iters`` calls
    after a warm-up call, the L2 flushed (FLUSH_BYTES written) before each.
    A CUDA event pair sits tight around the one call: the flush still runs
    when the call is enqueued, so the pair holds the call's device time
    and none of the host's. The host clock on the CPU, with no flush."""
    if device.type != "cuda":
        return _timer(device, iters)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)

    def cold_time(fn):
        fn()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    return cold_time


def _counted(fn):
    """``fn()`` and the kernel launches it made (a snapshot difference, so
    a caller's own count of the run is left whole)."""
    before = collections.Counter(dispatch.LAUNCHES)
    out = fn()
    after = collections.Counter(dispatch.LAUNCHES)
    after.subtract(before)
    return out, {k: v for k, v in after.items() if v}


def hop_sweep(mesh, cases):
    """The hop sweep: a block on rank 0's device pushed into a buffer on
    rank 1's (the ring's transport ``ring_hop_cuda``, its plain version on
    the CPU) and ``copy_`` of the same bytes, per size of
    ``cases.hop_bytes``, on the caller's stream. Each is held bitwise, then
    timed cold (``_cold_timer``) in turns (copy_, hop, hop, copy_; the
    smaller of each pair kept) and warm (``_timer``: back-to-back calls on
    the same buffers, L2-resident below 50 MB, host launch cost included
    where it exceeds the device time). ``calls``: the hop's calls in the
    row."""
    rows = []
    src_dev, dst_dev = mesh.devices[0], mesh.devices[1 % mesh.n]
    cold_ms = _cold_timer(src_dev, cases.hop_iters)
    warm_ms = _timer(src_dev, cases.hop_iters)
    gen = torch.Generator(device=src_dev).manual_seed(1)
    for nbytes in cases.hop_bytes:
        src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=gen, device=src_dev)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=dst_dev)
        ref = torch.empty_like(dst)
        if mesh.is_cuda:
            torch.cuda.synchronize()  # the buffers exist before another card writes them
        hop = _CallCount(lambda: ring_hop.ring_hop_cuda(src, dst))
        copy = _CallCount(lambda: ring_hop.ring_hop_plain(src, ref))
        hop()
        copy()
        bitwise = torch.equal(dst, ref)
        copy_cold = [cold_ms(copy)]
        hop_cold = [cold_ms(hop), cold_ms(hop)]
        copy_cold.append(cold_ms(copy))
        rows.append(dict(
            name=f"hop {nbytes} B", bytes=nbytes, bitwise=bitwise,
            hop_ms=min(hop_cold), copy_ms=min(copy_cold),
            hop_turns_ms=hop_cold, copy_turns_ms=copy_cold,
            hop_warm_ms=warm_ms(hop), copy_warm_ms=warm_ms(copy), calls=hop.calls,
        ))
        del src, dst, ref
    return rows


def flash_inputs(case, cases, device, seed=0):
    """q (B, H, S, D), k / v (B, K, S, D) of ``cases.dtype`` from a seeded
    generator on ``device``."""
    _, B, S, *_ = case
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cases.dtype)

    def make(heads):
        return torch.randn((B, heads, S, cases.head_dim), generator=gen, device=device).to(dt)

    return make(cases.heads), make(cases.kv_heads), make(cases.kv_heads)


def flash_ring(mesh, cases, time_ms, seed=0):
    """Each flash case through the ring: ``remote_copy=True`` with
    ``overlap`` on and off, and ``remote_copy=False``, against the
    unsharded call on the same inputs; then the ring (both schedules) and
    the unsharded call timed. ``launches``: the kernel launches of one call
    of each ring variant; ``calls``: the calls made of each variant and of
    the unsharded call (``full``); ``rel_err``: the Frobenius norm of ring
    - unsharded over the unsharded output's."""
    rows = []
    for case in cases.flash:
        label, B, S, causal, window, zigzag = case
        q, k, v = flash_inputs(case, cases, mesh.devices[0], seed)
        kw = dict(causal=causal, window=window, zigzag=zigzag)
        calls = {key: _CallCount(lambda ring_kw=ring_kw: ops.flash_attention(
                     q, k, v, mesh=mesh, **ring_kw, **kw))
                 for key, ring_kw in (("overlap", dict(overlap=True, remote_copy=True)),
                                      ("sync", dict(overlap=False, remote_copy=True)),
                                      ("copy", dict(overlap=True, remote_copy=False)))}
        calls["full"] = _CallCount(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                             window=window))
        full = calls["full"]()
        plan = partition.flash_plan(mesh, q, k, v, **kw)
        outs, launches = {}, {}
        for key in ("overlap", "sync", "copy"):
            outs[key], launches[key] = _counted(calls[key])
        diff = outs["overlap"].float() - full.float()
        rows.append(dict(
            name=f"flash ring {label}", B=B, S=S, causal=causal, window=window,
            zigzag=zigzag, note=plan.note if plan else "replicated",
            hops=plan.hops if plan else 0, launches=launches,
            max_abs_err=float(diff.abs().max()), max_abs_full=float(full.float().abs().max()),
            rel_err=float(diff.norm() / full.float().norm()),
            bitwise_overlap=torch.equal(outs["overlap"], outs["sync"]),
            bitwise_remote_copy=torch.equal(outs["overlap"], outs["copy"]),
            ring_ms=time_ms(calls["overlap"]), ring_sync_ms=time_ms(calls["sync"]),
            full_ms=time_ms(calls["full"]),
            calls={key: c.calls for key, c in calls.items()},
        ))
        del q, k, v, full, outs, diff, calls
    return rows


def decode_inputs(cases, n, device, seed=0):
    """q (B, H, D), a contiguous cache k / v (B, K, S, D), positions up to
    S - 1, and the same rows re-homed to the ring convention: rank r's
    local pool (slot 0 its null page) holds the pages behind table columns
    ``[r*nb_l, (r+1)*nb_l)``, which index it. Returns (q, k, v, position,
    k_pools, v_pools, table)."""
    B, nb, bs = cases.decode_batch, cases.decode_cols, cases.block_size
    K, D, S = cases.kv_heads, cases.head_dim, cases.decode_cols * cases.block_size
    dt = getattr(torch, cases.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, cases.heads, D), generator=gen, device=device).to(dt)
    k, v = (torch.randn((B, K, S, D), generator=gen, device=device).to(dt) for _ in range(2))
    # the first sequence fills the cache; the others end half-way through
    # earlier shards, so the shards after theirs merge as no-ops
    position = torch.tensor([S - 1] + [((2 * i - 1) * S) // (2 * B) for i in range(1, B)],
                            dtype=torch.int32, device=device)
    nb_l = nb // n
    p_l = B * nb_l + 1
    pools = []
    for x in (k, v):
        pages = x.reshape(B, K, nb, bs, D).permute(2, 0, 1, 3, 4)  # (nb, B, K, bs, D)
        pool = torch.zeros((n * p_l, K, bs, D), dtype=dt, device=device)
        for r in range(n):
            own = pages[r * nb_l:(r + 1) * nb_l].transpose(0, 1)  # (B, nb_l, K, bs, D)
            pool[r * p_l + 1:(r + 1) * p_l] = own.reshape(B * nb_l, K, bs, D)
        pools.append(pool)
    cols = torch.arange(nb, device=device) % nb_l
    table = (1 + torch.arange(B, device=device)[:, None] * nb_l + cols[None, :]).to(torch.int32)
    return q, k, v, position, pools[0], pools[1], table


def ring_decode_rows(mesh, cases, time_ms, seed=0):
    """Ring decode with the pools as given (``cases.dtype``) and as fp8
    e4m3 pools with their scales: against ``ring_decode_reference``
    (bitwise), ``overlap=False`` (bitwise) and contiguous decode of the
    same cache (at the same precision). ``launches``: the kernel launches
    of one ring call; ``calls``: the calls made of each variant."""
    q, k, v, pos, kp, vp, tbl = decode_inputs(cases, mesh.n, mesh.devices[0], seed)
    rows = []
    for pools in (cases.dtype, "fp8"):
        if pools == "fp8":
            kq, ks, vq, vs = prec.quantize_kv_cache(kp, vp, "fp8")
            scales, precision = dict(k_scale=ks, v_scale=vs), "fp8"
        else:
            kq, vq, scales, precision = kp, vp, {}, None
        calls = {
            "ring": _CallCount(lambda: ring_decode(q, kq, vq, tbl, pos, mesh, **scales)),
            "sync": _CallCount(lambda: ring_decode(q, kq, vq, tbl, pos, mesh, overlap=False,
                                                   **scales)),
            "reference": _CallCount(lambda: ring_decode_reference(q, kq, vq, tbl, pos, mesh.n,
                                                                  **scales)),
            "contiguous": _CallCount(lambda: ops.decode_attention(q, k, v, pos,
                                                                  precision=precision)),
        }
        contiguous = calls["contiguous"]()
        got, launches = _counted(calls["ring"])
        sync, ref = calls["sync"](), calls["reference"]()
        diff = (got.float() - contiguous.float()).norm() / contiguous.float().norm().clamp_min(1e-30)
        rows.append(dict(
            name=f"ring decode {pools} pools", pools=pools, launches=launches,
            bitwise_reference=torch.equal(got, ref), bitwise_overlap=torch.equal(got, sync),
            rel_err_contiguous=float(diff),
            ring_ms=time_ms(calls["ring"]), reference_ms=time_ms(calls["reference"]),
            calls={key: c.calls for key, c in calls.items()},
        ))
    return rows


def run(device=None, n=4, cases=CARD, devices=None):
    """The hop sweep, the flash ring and ring decode on a ``RingMesh`` of
    ``n`` ranks: on ``device`` (``resolve_device``: the card unless the
    caller passes ``device="cpu"``), or one rank per entry of
    ``devices``. Returns {"device", "ranks", "cards", "hops", "flash",
    "decode"}."""
    if devices is None:
        mesh = RingMesh(n, device=device)
    else:
        mesh = RingMesh(n, devices=devices)
    dev = mesh.devices[0]
    time_ms = _timer(dev, cases.iters)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return dict(
        device=name, ranks=n, cards=len(set(mesh.devices)),
        hops=hop_sweep(mesh, cases),
        flash=flash_ring(mesh, cases, time_ms),
        decode=ring_decode_rows(mesh, cases, time_ms),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=4, help="ranks on the ring")
    ap.add_argument("--small", action="store_true", help="the SMALL cases")
    args = ap.parse_args(argv)
    out = run(resolve_device(args.device), n=args.n, cases=SMALL if args.small else CARD)
    for kind in ("hops", "flash", "decode"):
        for row in out[kind]:
            print(json.dumps({"device": out["device"], **row}))


if __name__ == "__main__":
    main()
