"""Measured search over the kernels' run-time plans and the plain forms'
block sizes (port of ``repro.launch.autotune``).

Per **(op, operand shapes, dtypes, backend, impl)** it

1. lists the candidates: on the card, the plans a kernel's planner weighs
   (``candidates(...)`` of ``hopper/gemm.py``, ``gemm_scaled.py``,
   ``spmm.py``, ``spmspm.py``, ``stencil.py``, ``flash_attention.py``);
   elsewhere, and for the knobs a plain form or the scan reads at run
   time (``decode_attention``'s ``bs``, ``linear_attention``'s ``chunk``),
   the block dicts of ``dispatch``'s table, as the reference tunes them;
2. prunes a plan that passes the card's limits before anything runs: a
   CTA's shared memory (``smem_budget``), its threads and registers. The
   plain forms hold no shared memory, so block dicts are not pruned;
3. times the survivors through the normal dispatch (``ops.*``), each staged
   with ``dispatch.plan_override`` (at exactly the planner's arguments) or
   ``dispatch.block_override``, after holding its output to the default's:
   bitwise for the ELL SpMM and the stencil, else at the op's tolerance. A
   kernel plan whose output differs raises (a fault of the kernel at a plan
   the model may pick at some shape); a block dict that differs is listed
   under ``mismatched`` and never chosen;
4. times the default first and last, and records a candidate only if it
   beat the better of those two readings; and
5. writes a JSON record that ``apply_record`` replays without a search.

Knobs that change what an op computes are held at their defaults: the
scaled GEMM's ``bk`` is its quantization block, and the wgmma route's
promotion interval sets what the fp8 sum rounds.

Timing: on a card, the median of ``reps`` groups, each of back-to-back
calls between CUDA events after a warm-up (a kernel's device time and a
host-bound form's launch cost alike); on the CPU, the median wall of
``reps`` calls. Under a mesh (``DeviceMesh`` on one card's streams) every
case runs through the sharded dispatch and keys its entry by the local
shard shapes (``local_case_shapes``).

    PYTHONPATH=src python -m repro_torch.launch.block_search --device cpu --out r.json
    PYTHONPATH=src python -m repro_torch.launch.block_search   # on the card, its shapes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.hopper import dispatch, ops

RECORD_VERSION = 1
SMEM_BUDGET_BYTES = 232448  # 227 KB of shared memory a CTA may use on an H100
H100_SMS = 132  # the SMs a plan search off the card plans for
FP32_TOL = 1e-4
BF16_TOL = 2.0 ** -7  # one bf16 step


@dataclasses.dataclass
class TuneCase:
    """One tunable call.

    ``op`` — the dispatch op; ``args`` — operands, passed positionally to
    ``fn(*args, mesh=None)``, which runs through ``ops.*``; ``candidates``
    — partial block dicts of the plain form, merged onto the table's
    defaults; ``traffic(blocks)`` — bytes the plain form moves at a block
    dict (every block re-read each step), the warm-start prior;
    ``plan_kwargs`` — keywords the op's partition rule needs;
    ``mesh``/``precision``/``consumer`` — as the reference's (set by
    ``autotune``; the policy name and call-site class key the entry);
    ``planner(structs, sms, smem_budget)`` — on a card, the kernel's plan
    op, its planner's arguments at these operand structs, and its
    ``candidates`` (None where the card tunes block dicts); ``hold`` —
    block names held at the default (semantic); ``fixed`` — why the card
    has nothing to tune for this op, where it has not; ``exact`` — outputs
    held bitwise.
    """

    op: str
    args: tuple
    fn: Callable
    candidates: list[dict]
    traffic: Callable[[dict], int]
    plan_kwargs: dict = dataclasses.field(default_factory=dict)
    mesh: Any = None
    precision: str | None = None
    consumer: str | None = None
    planner: Callable | None = None
    hold: tuple = ()
    fixed: str | None = None
    exact: bool = False


class SearchFault(RuntimeError):
    """A kernel plan gave another output than the model's pick."""


def mesh_tag(mesh) -> str | None:
    """``mesh``'s tag: ``"2x4"`` / ``"2x2x2"`` (axis sizes in axis order),
    or None without a mesh."""
    if mesh is None:
        return None
    return "x".join(str(int(mesh.shape[a])) for a in mesh.axis_names)


def _structs(arrays) -> tuple:
    return tuple((tuple(a.shape), a.dtype) for a in arrays if a is not None)


def local_case_shapes(case: TuneCase, impl: str | None = None) -> tuple:
    """``(shape, dtype)`` of each operand that keys ``case``'s entry: the
    operands themselves without a mesh, else the per-rank parts under the
    op's partition plan (``partition.local_operand_structs``) for the
    dispatch ``impl``; a plan that replicates keys as the unmeshed case."""
    if case.mesh is None:
        return _structs(case.args)
    from repro_torch.hopper import partition

    plan = partition.plan_for(case.op, case.mesh, *case.args, impl=impl, **case.plan_kwargs)
    return partition.local_operand_structs(plan, case.mesh, case.args)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def case_key(op: str, arrays, backend: str, impl: str, precision: str | None = None,
             consumer: str | None = None) -> str:
    """``op|shapes:dtypes|backend|impl``, ``|precision`` for a policy's
    entry and ``#consumer`` for a call-site class's. ``arrays``: tensors or
    ``(shape, dtype)`` pairs."""
    structs = [a if isinstance(a, tuple) else (tuple(a.shape), a.dtype) for a in arrays]
    shapes = ",".join(f"{'x'.join(map(str, s))}:{_dtype_name(d)}" for s, d in structs)
    key = f"{op}|{shapes}|{backend}|{impl}"
    if precision is not None:
        key = f"{key}|{precision}"
    return key if consumer is None else f"{key}#{consumer}"


def backend_name(device=None) -> str:
    """``"cpu"``, or the card's name and SM count: a record applies only on
    a card of the same name and SMs. ``device`` defaults to the first card
    where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    props = torch.cuda.get_device_properties(index)
    return f"{props.name} ({props.multi_processor_count} SMs)"


def session_impl() -> str:
    """The session's default impl (``dispatch.default_impl``), ``auto``
    when none is set."""
    return dispatch.current_default_impl() or "auto"


def _device_of(case: TuneCase) -> torch.device:
    return next(a.device for a in case.args if isinstance(a, torch.Tensor))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(call, device, *, reps: int, warmup: int = 2, group_ms: float = 10.0) -> float:
    """Seconds a call of ``call()``: on a card, the median of ``reps``
    groups of back-to-back calls between CUDA events (each group sized to
    about ``group_ms``); on the CPU, the median wall of ``reps`` calls."""
    for _ in range(warmup):
        call()
    _sync(device)
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    n = max(1, min(200, int(group_ms / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n / 1e3)
    return sorted(times)[len(times) // 2]


def candidate_prior_seconds(case: TuneCase, blocks: dict) -> float:
    """The warm-start prior of the block dict ``blocks``:
    ``roofline.bound_ms`` of the bytes the plain form moves at it
    (``case.traffic``), in seconds."""
    from repro_torch.launch import roofline

    return roofline.bound_ms(0.0, case.traffic(blocks))[0] / 1e3


def _outputs(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def checksum(out) -> list[float]:
    """Each output of ``out`` (a tensor or a tuple of them) summed in
    fp64: what a replayed winner is held to."""
    return [float(o.double().sum()) for o in _outputs(out)]


def _agree(got, want, exact: bool) -> bool:
    for g, w in zip(_outputs(got), _outputs(want)):
        if exact:
            if not torch.equal(g, w):
                return False
            continue
        tol = BF16_TOL if torch.bfloat16 in (g.dtype, w.dtype) else FP32_TOL
        g, w = g.float(), w.float()
        scale = float(w.abs().max()) if w.numel() else 0.0
        if not torch.allclose(g, w, rtol=tol, atol=tol * max(scale, 1.0)):
            return False
    return True


def _knob(case: TuneCase, device) -> str:
    """``"plan"`` (a kernel's run-time plan), ``"blocks"`` (the block
    table) or ``"fixed"`` (nothing the card can tune for this op)."""
    if torch.device(device).type != "cuda":
        return "blocks"
    if case.fixed:
        return "fixed"
    return "plan" if case.planner is not None else "blocks"


def _sms(device) -> int:
    from repro_torch.device import sm_count

    device = torch.device(device)
    return sm_count(torch.cuda.current_device() if device.index is None else device.index)


def encode_args(args) -> list:
    """A planner's arguments ``args`` as JSON: dtypes as ``{"dtype":
    name}``, tuples as lists."""
    def enc(x):
        if isinstance(x, torch.dtype):
            return {"dtype": _dtype_name(x)}
        if isinstance(x, (tuple, list)):
            return [enc(v) for v in x]
        return x
    return enc(list(args))


def decode_args(args) -> tuple:
    """``encode_args`` undone on ``args``: lists back to tuples, dtypes to
    torch's."""
    def dec(x):
        if isinstance(x, dict):
            return getattr(torch, x["dtype"])
        if isinstance(x, list):
            return tuple(dec(v) for v in x)
        return x
    return dec(args)


def planners() -> dict[str, Callable]:
    """Each plan op's ``candidates`` function."""
    from repro_torch.hopper import flash_attention, gemm, gemm_scaled, spmm, spmspm, stencil

    return {"gemm": gemm.candidates, "gemm_scaled": gemm_scaled.candidates,
            "spmm": spmm.candidates, "spmspm": spmspm.candidates,
            "stencil": stencil.candidates, "flash_attention": flash_attention.candidates}


def plan_of(plan_op: str, plan_args, knobs: dict):
    """The plan of ``plan_op``'s candidates at ``plan_args`` whose knobs are
    ``knobs``; raises where there is none."""
    for c in planners()[plan_op](*plan_args):
        if c.knobs == knobs:
            return c.plan
    raise ValueError(f"{plan_op}: no plan with knobs {knobs} at {plan_args}")


def autotune_case(case: TuneCase, *, smem_budget: int = SMEM_BUDGET_BYTES, reps: int = 3,
                  trial_budget: int | None = None, time_candidate: Callable | None = None,
                  run_candidate: Callable | None = None, device=None,
                  impl: str | None = None, knob: str | None = None) -> dict:
    """Search one case; returns its record entry (winner and audit trail).

    ``smem_budget`` — the shared memory a CTA may take (plans past it are
    pruned); ``reps`` — timed groups a candidate; ``trial_budget`` — at
    most this many candidates timed, in warm-start order (the default
    always); ``time_candidate(case, blocks)`` / ``run_candidate(case,
    blocks)`` — seconds and output of one staged call, injectable (by
    default the call runs through ``case.fn``; with an injected timer and
    no ``run_candidate`` no output is checked); ``device`` — where the case
    runs (default: its operands'), which decides the knob unless ``knob``
    (``"plan"``, ``"blocks"`` or ``"fixed"``) is given: off the card a plan
    search is planned for an H100's ``H100_SMS`` and its outputs are the
    plain form's; ``impl`` — the dispatch impl whose partition plan keys
    a meshed case's shapes.

    Warm start: block dicts by ``candidate_prior_seconds``, plans by their
    planner's cost; ties keep the list order (the default first)."""
    device = torch.device(device) if device is not None else _device_of(case)
    kind = knob or _knob(case, device)
    plan_op = plan_args = None
    if kind == "plan":
        sms = _sms(device) if device.type == "cuda" else H100_SMS
        structs = local_case_shapes(case, impl)
        plan_op, plan_args, cands = case.planner(case, structs, sms, smem_budget)
        _, _, model = case.planner(case, structs, sms, SMEM_BUDGET_BYTES)
        defaults = dispatch.model_pick(model).knobs
        ordered = [dict(c.knobs) for c in cands]
        meta = {id(f): c for f, c in zip(ordered, cands)}
        pruned = [{"blocks": f, "smem_bytes": meta[id(f)].smem, "threads": meta[id(f)].threads,
                   "why": meta[id(f)].why} for f in ordered if not meta[id(f)].feasible]
        feasible = [f for f in ordered if meta[id(f)].feasible]
        feasible.sort(key=lambda f: meta[id(f)].key)
        prior = {id(f): meta[id(f)].cost for f in feasible}
        prior_name = "prior_cost"
        plan_of_knobs = {tuple(f.items()): meta[id(f)].plan for f in ordered}

        def stage(full):
            return dispatch.plan_override(plan_op, plan_args, plan_of_knobs[tuple(full.items())])
    else:
        defaults = dispatch.block_defaults(case.op, overrides=False)
        held = {h: defaults[h] for h in case.hold}
        seen, ordered = set(), []
        for cand in [{}] + ([] if kind == "fixed" else list(case.candidates)):
            full = {**defaults, **cand, **held}
            sig = tuple(sorted(full.items()))
            if sig not in seen:
                seen.add(sig)
                ordered.append(full)
        pruned, feasible = [], list(ordered)  # the plain forms hold no shared memory
        prior = {id(f): candidate_prior_seconds(case, f) for f in feasible}
        feasible.sort(key=lambda f: prior[id(f)])
        prior_name = "prior_s"

        def stage(full):
            return dispatch.block_override(case.op, **full)

    skipped = []
    if trial_budget is not None:
        keep = feasible[: max(int(trial_budget), 1)]
        if defaults in feasible and defaults not in keep:
            keep.append(next(f for f in feasible if f == defaults))
        skipped = [{"blocks": f, prior_name: prior[id(f)]} for f in feasible
                   if not any(f is k for k in keep)]
        feasible = keep

    check = time_candidate is None or run_candidate is not None
    if run_candidate is None:
        def run_candidate(case, blocks):
            with torch.no_grad():
                return case.fn(*case.args, mesh=case.mesh)
    if time_candidate is None:
        def time_candidate(case, blocks):
            with torch.no_grad():
                return _time_call(lambda: case.fn(*case.args, mesh=case.mesh), device, reps=reps)

    default = next((f for f in feasible if f == defaults), None)
    want, sums = None, {}
    if default is not None and check:
        with stage(default):
            want = run_candidate(case, default)
        sums[id(default)] = checksum(want)
    readings = []
    if default is not None:
        with stage(default):
            readings.append(time_candidate(case, default) * 1e6)
    timed, mismatched = [], []
    for full in feasible:
        if full is default:  # its time comes with its last reading
            timed.append({"blocks": default, "us_per_call": None, prior_name: prior[id(default)]})
            continue
        with stage(full):
            if check:
                hits = dispatch.PLAN_HITS[plan_op] if kind == "plan" else 0
                got = run_candidate(case, full)
                if kind == "plan" and device.type == "cuda" and dispatch.PLAN_HITS[plan_op] == hits:
                    raise SearchFault(f"{case.op}: the {plan_op} plan {full} at {plan_args} was "
                                      f"not reached: the call's planner arguments differ")
                if want is not None and not _agree(got, want, case.exact):
                    if kind == "plan":
                        raise SearchFault(
                            f"{case.op}: the {plan_op} plan {full} at {plan_args} gives another "
                            f"output than the model's pick {defaults}")
                    mismatched.append({"blocks": full, prior_name: prior[id(full)]})
                    continue
                sums[id(full)] = checksum(got)
                del got
            timed.append({"blocks": full, "us_per_call": time_candidate(case, full) * 1e6,
                          prior_name: prior[id(full)]})
            if id(full) in sums:
                timed[-1]["checksum"] = sums[id(full)]
    default_entry = None
    if default is not None:
        with stage(default):
            readings.append(time_candidate(case, default) * 1e6)
        default_entry = next(t for t in timed if t["blocks"] is default)
        default_entry["us_per_call"] = min(readings)
        if id(default) in sums:
            default_entry["checksum"] = sums[id(default)]

    # a candidate is recorded only if it beat the default's better reading
    best = default_entry or (timed[0] if timed else None)
    for t in timed:
        if best is None or t["us_per_call"] < best["us_per_call"]:
            best = t
    entry = {
        "op": case.op,
        "precision": case.precision,
        "consumer": case.consumer,
        "knob": kind,
        "blocks": best["blocks"] if best else defaults,
        "us_per_call": best["us_per_call"] if best else None,
        "default_blocks": defaults,
        "default_us": default_entry["us_per_call"] if default_entry else None,
        "default_readings_us": readings,
        "timed": timed,
        "pruned": pruned,
        "mismatched": mismatched,
        "skipped_by_budget": skipped,
        "trial_budget": trial_budget,
        "smem_budget_bytes": smem_budget,
    }
    if kind == "plan":
        entry["plan_op"] = plan_op
        entry["plan_args"] = encode_args(plan_args)
        by_time = sorted(timed, key=lambda t: t["us_per_call"])
        entry["model_rank"] = next((i + 1 for i, t in enumerate(by_time)
                                    if t["blocks"] == defaults), None)
    if kind == "fixed":
        entry["note"] = case.fixed
    return entry


# ---------------------------------------------------------------------------
# The suite: one call per op with a knob, at the reference's shapes (the
# CPU tests) or at the card's (the shapes PERF.md's kernel rows were timed at)
# ---------------------------------------------------------------------------


def _normal(rng, shape, device, dtype=torch.float32, card=False, gen=None):
    if card:
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _card_gen(rng, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    return gen


def _vec4(*ns) -> bool:
    return all(n % 4 == 0 for n in ns)


def _gemm_planner(case, structs, sms, budget):
    from repro_torch.hopper import gemm

    (M, K), _ = structs[0]
    N = structs[1][0][1]
    if case.mesh is None:
        vec = gemm.vec16(*case.args)
    else:
        vec = _vec4(K, N)
    args = (M, N, K, sms, vec)
    return "gemm", args, gemm.candidates(*args, smem_budget=budget)


def _gemm_traffic(M, N, K, esize=4, scales=False):
    def traffic(bl):
        bm, bk, bn = min(bl["bm"], M), min(bl["bk"], K), min(bl["bn"], N)
        steps = -(-M // bm) * -(-N // bn) * -(-K // bk)
        per = esize * (bm * bk + bk * bn) + 4 * bm * bn + (4 * (bm + bn) if scales else 0)
        return steps * per
    return traffic


def _gemm_case(rng, *, device="cpu", card=False) -> TuneCase:
    if card:  # the GCN's first product at ogbn-arxiv's size
        gen = _card_gen(rng, device)
        (m, k), n = (169343, 144), 144
        a = _normal(rng, (m, k), device, card=True, gen=gen)
        b = _normal(rng, (k, n), device, card=True, gen=gen)
    else:
        m = k = n = 256
        a, b = _normal(rng, (m, k), device), _normal(rng, (k, n), device)
    return TuneCase("gemm", (a, b), lambda a, b, mesh=None: ops.gemm(a, b, mesh=mesh),
                    [{"bm": s, "bk": s, "bn": s} for s in (64, 128, 256)],
                    _gemm_traffic(m, n, k), planner=_gemm_planner)


def _fa_planner(case, structs, sms, budget):
    from repro_torch.hopper import flash_attention

    (B, H, Sq, D), dtype = structs[0]
    args = (B, H, Sq, D, dtype, sms)
    return "flash_attention", args, flash_attention.candidates(*args, smem_budget=budget)


def _fa_traffic(B, H, sq, S, D, esize):
    def traffic(bl):
        bq, bk = min(bl["bq"], sq), min(bl["bk"], S)
        steps = B * H * -(-sq // bq) * -(-S // bk)
        return steps * esize * (2 * bq * D + 2 * bk * D)
    return traffic


def _flash_case(rng, device, card, consumer):
    if card:  # occamy-gptj's prefill attention (S = 512 bucket, bf16)
        B, H, S, D, dtype = 1, 16, 512, 256, torch.bfloat16
    else:
        B, H, S, D, dtype = 1, 4, 256, 64, torch.float32
    gen = _card_gen(rng, device) if card else None
    sq = 1 if consumer == "decode" else S
    q = _normal(rng, (B, H, sq, D), device, dtype, card, gen)
    k, v = (_normal(rng, (B, H, S, D), device, dtype, card, gen) for _ in range(2))
    q_offset = S - 1 if consumer == "decode" else 0
    return TuneCase(
        "flash_attention", (q, k, v),
        lambda q, k, v, mesh=None: ops.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                                       mesh=mesh),
        [{"bk": s} for s in (32, 64, 128, 256)], _fa_traffic(B, H, sq, S, D, q.element_size()),
        planner=_fa_planner, consumer=consumer)


def _flash_attention_case(rng, *, device="cpu", card=False) -> TuneCase:
    return _flash_case(rng, device, card, None)


def _linear_attention_case(rng, *, device="cpu", card=False) -> TuneCase:
    if card:  # rwkv6-3b's scan (B = 4, T = 2048, 40 heads of 64), bf16 r/k/v
        B, H, T, N, dtype = 4, 40, 2048, 64, torch.bfloat16
        gen = _card_gen(rng, device)
        r, k, v = (_normal(rng, (B, H, T, N), device, dtype, True, gen) for _ in range(3))
        w = -torch.rand((B, H, T, N), generator=gen, device=device) * 0.99 - 0.01
    else:
        B, H, T, N = 1, 2, 256, 64
        r, k, v = (_normal(rng, (B, H, T, N), device) for _ in range(3))
        w = torch.from_numpy(-rng.uniform(0.01, 1.0, (B, H, T, N)).astype(np.float32)).to(device)
    esize = r.element_size()

    def traffic(bl):
        chunk = min(bl["chunk"], T)
        steps = B * H * -(-T // chunk)
        return steps * (4 * chunk * N * esize + chunk * N * 4 + 2 * N * N * 4 + N * 4)

    return TuneCase("linear_attention", (r, k, v, w),
                    lambda r, k, v, w, mesh=None: ops.linear_attention(r, k, v, w, mesh=mesh),
                    [{"chunk": s} for s in (8, 16, 32)], traffic)


def _spmm_planner(case, structs, sms, budget):
    from repro_torch.hopper import spmm

    (R, L), _ = structs[0]
    (C, F), dtype = structs[2]
    esize = torch.empty((), dtype=dtype).element_size()
    vec = spmm.vec16(case.args[2]) if case.mesh is None else F % (16 // esize) == 0
    args = (R, L, C, F, esize, vec)
    return "spmm", args, spmm.candidates(*args)


def _spmm_case(rng, *, device="cpu", card=False) -> TuneCase:
    from repro_torch.core.sparse import random_ell

    if card:  # the GCN's aggregation at ogbn-arxiv's size (L = 15)
        R = C = 169343
        L, F = 15, 144
        gen = _card_gen(rng, device)
        values = torch.rand((R, L), generator=gen, device=device)
        cols = torch.randint(0, C, (R, L), generator=gen, device=device, dtype=torch.int32)
        dense = _normal(rng, (C, F), device, card=True, gen=gen)
    else:
        R, C, F = 512, 256, 64
        A = random_ell(rng, R, C, 0.05)
        dense = _normal(rng, (C, F), device)
        values, cols = A.values.to(device), A.cols.to(device)
        L = values.shape[1]

    def traffic(bl):
        bm = min(bl["bm"], R)
        return -(-R // bm) * (bm * L * 8 + C * F * 4 + bm * F * 4)

    return TuneCase("spmm", (values, cols, dense),
                    lambda v, c, d, mesh=None: ops.spmm(v, c, d, mesh=mesh),
                    [{"bm": s} for s in (32, 64, 128, 256)], traffic, planner=_spmm_planner,
                    exact=True)


def _bsr_spmm_case(rng, *, device="cpu", card=False) -> TuneCase:
    from repro_torch.core.sparse import dense_to_bsr

    if card:  # the sparse trio's BSR at 2.8 %: every 8 x 128 tile holds entries
        R, K, F, bm, bk = 8192, 16384, 256, 8, 128
        gen = _card_gen(rng, device)
        nr, nc = R // bm, K // bk
        tile_rows = torch.arange(nr, device=device, dtype=torch.int32).repeat_interleave(nc)
        tile_cols = torch.arange(nc, device=device, dtype=torch.int32).repeat(nr)
        tv = torch.randn((nr * nc, bm, bk), generator=gen, device=device)
        dense = _normal(rng, (K, F), device, card=True, gen=gen)
        T = nr * nc
    else:
        R, K, F = 256, 256, 512
        mat = np.zeros((R, K), np.float32)
        mask = rng.random((R, K)) < 0.05
        mat[mask] = rng.standard_normal(mask.sum())
        A = dense_to_bsr(torch.from_numpy(mat), bm=8, bk=128)
        dense = _normal(rng, (K, F), device)
        tv, tile_rows, tile_cols = (x.to(device) for x in (A.tile_values, A.tile_rows,
                                                             A.tile_cols))
        T, bm, bk = tv.shape

    def traffic(bl):
        bf = min(bl["bf"], F)
        return T * -(-F // bf) * 4 * (bm * bk + bk * bf + bm * bf)

    return TuneCase("bsr_spmm", (tv, tile_rows, tile_cols, dense),
                    lambda tv, tr, tc, d, mesh=None: ops.bsr_spmm(tv, tr, tc, d, R, mesh=mesh),
                    [{"bf": s} for s in (128, 256, 512)], traffic,
                    plan_kwargs={"num_rows": R},
                    fixed="the BSR kernel has no run-time geometry: its tiles are the "
                          "source's constants")


def _spmspm_planner(case, structs, sms, budget):
    from repro_torch.hopper import spmspm

    (R, _), _ = structs[0]
    (C, Lb), _ = structs[2]
    args = (R, C, Lb, int(case.plan_kwargs["contraction_dim"]))
    return "spmspm", args, spmspm.candidates(*args)


def _spmspm_case(rng, *, device="cpu", card=False) -> TuneCase:
    from repro_torch.core.sparse import random_ell

    if card:  # the sparse trio's 2.8 % left at 1 % right (La 459, Lb 164)
        R, C, K, La, Lb = 4096, 4096, 16384, 459, 164
        gen = _card_gen(rng, device)
        av, bv = (torch.rand(s, generator=gen, device=device) for s in ((R, La), (C, Lb)))
        ac = torch.randint(0, K, (R, La), generator=gen, device=device, dtype=torch.int32)
        bc = torch.randint(0, K, (C, Lb), generator=gen, device=device, dtype=torch.int32)
    else:
        R, C, K = 128, 128, 256
        A, B = random_ell(rng, R, K, 0.05), random_ell(rng, C, K, 0.05)
        av, ac, bv, bc = (x.to(device) for x in (A.values, A.cols, B.values, B.cols))
        La, Lb = av.shape[1], bv.shape[1]

    def traffic(bl):
        bm, bn = min(bl["bm"], R), min(bl["bn"], C)
        return -(-R // bm) * -(-C // bn) * (8 * bm * La + 8 * bn * Lb + 4 * bm * bn)

    return TuneCase("spmspm", (av, ac, bv, bc),
                    lambda av, ac, bv, bc, mesh=None: ops.spmspm(av, ac, bv, bc, K, mesh=mesh),
                    [{"bm": m, "bn": n} for m in (8, 16, 32) for n in (64, 128)], traffic,
                    plan_kwargs={"contraction_dim": K}, planner=_spmspm_planner)


BOX27 = np.asarray([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)])
STAR7 = np.array([(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
                 np.int32)


def _stencil_case(rng, *, device="cpu", card=False) -> TuneCase:
    from repro_torch.hopper import stencil

    if card:  # the sparse trio's j3d27pt on a 512^3 grid
        X, Y, Z = 512, 512, 512
        offsets = BOX27
        gen = _card_gen(rng, device)
        grid = _normal(rng, (X, Y, Z), device, card=True, gen=gen)
        weights = np.asarray(torch.rand(len(offsets), generator=gen, device=device).cpu(),
                             np.float32)
    else:
        X, Y, Z = 64, 32, 32
        grid = _normal(rng, (X, Y, Z), device)
        offsets = STAR7
        weights = np.full(len(offsets), 1.0 / len(offsets), np.float32)

    def planner(case, structs, sms, budget):
        (shape, _), = structs
        red = stencil.reduce_offsets(offsets, shape)
        args = stencil.plan_args(shape, red, sms)
        return "stencil", args, stencil.candidates(*args, smem_budget=budget)

    def traffic(bl):
        bx = min(bl["bx"], X)
        return -(-X // bx) * 4 * bx * Y * Z * 4

    return TuneCase("stencil", (grid,),
                    lambda g, mesh=None: ops.stencil(g, offsets, weights, mesh=mesh),
                    [{"bx": s} for s in (4, 8, 16, 32)], traffic,
                    plan_kwargs={"offsets": offsets, "weights": weights}, planner=planner,
                    exact=True)


def _decode_attention_case(rng, *, device="cpu", card=False) -> TuneCase:
    """The contiguous cache: ``bs`` cuts it into the blocks the decode
    kernel splits over (and the plain form loops over, one block a step)."""
    if card:  # occamy-gptj's contiguous generate: B = 4 at 512 + 16 tokens, bf16
        B, H, K, S, D, dtype = 4, 16, 16, 528, 256, torch.bfloat16
        gen = _card_gen(rng, device)
    else:
        B, H, K, S, D, dtype, gen = 2, 8, 4, 1024, 64, torch.float32, None
    q = _normal(rng, (B, H, D), device, dtype, card, gen)
    k = _normal(rng, (B, K, S, D), device, dtype, card, gen)
    v = _normal(rng, (B, K, S, D), device, dtype, card, gen)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=device)
    esize = q.element_size()

    def traffic(bl):
        bs = min(bl["bs"], S)
        return -(-S // bs) * esize * (2 * B * K * bs * D + 2 * B * H * D)

    return TuneCase("decode_attention", (q, k, v, pos),
                    lambda q, k, v, p, mesh=None: ops.decode_attention(q, k, v, p, mesh=mesh),
                    [{"bs": s} for s in (128, 256, 512, 1024)], traffic)


DEFAULT_SUITE: dict[str, Callable] = {
    "gemm": _gemm_case,
    "flash_attention": _flash_attention_case,
    "linear_attention": _linear_attention_case,
    "spmm": _spmm_case,
    "bsr_spmm": _bsr_spmm_case,
    "spmspm": _spmspm_case,
    "stencil": _stencil_case,
    "decode_attention": _decode_attention_case,
}


def _scaled_planner(policy):
    def planner(case, structs, sms, budget):
        from repro_torch.core import precision as prec
        from repro_torch.hopper import gemm_scaled

        p = prec.resolve(policy)
        (M, K), _ = structs[0]
        N = structs[1][0][1]
        bk = min(dispatch.resolve_blocks("gemm")["bk"], K)
        esize = torch.empty((), dtype=p.compute_dtype).element_size()
        aligned = K * esize % 16 == 0 and N * esize % 16 == 0
        args = (M, N, K, bk, p.compute_dtype, aligned, sms)
        return "gemm_scaled", args, gemm_scaled.candidates(*args, smem_budget=budget)
    return planner


def _gemm_precision_case(policy: str) -> Callable:
    """``gemm`` under ``precision=policy``: the scaled kernel on the card.
    ``bk`` is the quantization block, so it is held at the default: the
    candidates vary bm and bn on the CPU and the wgmma plan on the card."""

    def factory(rng, *, device="cpu", card=False) -> TuneCase:
        from repro_torch.core import precision as prec

        p = prec.resolve(policy)
        if card:  # the precision ladder's card GEMM (2048 x 4096 x 16384)
            gen = _card_gen(rng, device)
            m, k, n = 2048, 4096, 16384
            a = _normal(rng, (m, k), device, card=True, gen=gen)
            b = _normal(rng, (k, n), device, card=True, gen=gen)
        else:
            m = k = n = 256
            a, b = _normal(rng, (m, k), device), _normal(rng, (k, n), device)
        esize = torch.empty((), dtype=p.compute_dtype).element_size()
        return TuneCase(
            "gemm", (a, b), lambda a, b, mesh=None: ops.gemm(a, b, precision=p, mesh=mesh),
            [{"bm": s, "bk": s, "bn": s} for s in (64, 128, 256)],
            _gemm_traffic(m, n, k, esize, scales=True), plan_kwargs={"precision": p},
            precision=p.name, planner=_scaled_planner(policy), hold=("bk",))

    return factory


PRECISION_SUITE: dict[str, Callable] = {
    "gemm@fp8": _gemm_precision_case("fp8"),
    "gemm@bf16": _gemm_precision_case("bf16"),
}


def _flash_attention_consumer_case(consumer: str) -> Callable:
    def factory(rng, *, device="cpu", card=False) -> TuneCase:
        return _flash_case(rng, device, card, consumer)
    return factory


def _decode_attention_consumer_case() -> Callable:
    def factory(rng, *, device="cpu", card=False) -> TuneCase:
        case = _decode_attention_case(rng, device=device, card=card)
        case.consumer = "decode"
        return case
    return factory


CONSUMER_SUITE: dict[str, Callable] = {
    "flash_attention#prefill": _flash_attention_consumer_case("prefill"),
    "flash_attention#decode": _flash_attention_consumer_case("decode"),
    "decode_attention#decode": _decode_attention_consumer_case(),
}


def full_suite() -> dict[str, Callable]:
    """DEFAULT_SUITE, PRECISION_SUITE and CONSUMER_SUITE: every entry the
    CLI searches."""
    return {**DEFAULT_SUITE, **PRECISION_SUITE, **CONSUMER_SUITE}


# ---------------------------------------------------------------------------
# Record: search, persist, replay
# ---------------------------------------------------------------------------


def autotune(ops_subset=None, *, smem_budget: int = SMEM_BUDGET_BYTES, reps: int = 3,
             seed: int = 0, suite: dict[str, Callable] | None = None, mesh: Any = None,
             trial_budget: int | None = None, time_candidate: Callable | None = None,
             run_candidate: Callable | None = None, device=None, card: bool | None = None,
             on_entry: Callable | None = None) -> dict:
    """Search every suite case; returns the record (version, backend, impl,
    mesh tag, entries). Winners are not applied: call ``apply_record``.

    ``ops_subset`` — suite names to search (None: all of ``suite``, by
    default ``DEFAULT_SUITE``); ``seed`` — the operands' random seed;
    ``mesh`` — tune through the sharded dispatch on this mesh;
    ``device`` — where the cases run (default ``cuda``; raises without a
    card unless given); ``card`` — the card's shapes (default: on a card)
    or the reference's; ``on_entry(name, key, entry)`` — called after each
    case. ``smem_budget``, ``reps``, ``trial_budget``, ``time_candidate``
    and ``run_candidate`` as ``autotune_case`` takes them."""
    from repro_torch.device import resolve_device

    suite = DEFAULT_SUITE if suite is None else suite
    if ops_subset:
        unknown = set(ops_subset) - set(suite)
        if unknown:
            raise KeyError(f"unknown autotune ops {sorted(unknown)}; known: {sorted(suite)}")
    device = resolve_device(device)
    card = device.type == "cuda" if card is None else card
    backend, impl = backend_name(device), session_impl()
    rng = np.random.default_rng(seed)
    entries = {}
    for name, factory in suite.items():
        if ops_subset and name not in ops_subset:
            continue
        case = factory(rng, device=device, card=card)
        case.mesh = mesh
        entry = autotune_case(case, smem_budget=smem_budget, reps=reps,
                              trial_budget=trial_budget, time_candidate=time_candidate,
                              run_candidate=run_candidate, device=device,
                              impl=dispatch.resolve_impl(case.op))
        key = case_key(case.op, local_case_shapes(case, dispatch.resolve_impl(case.op)),
                       backend, impl, precision=case.precision, consumer=case.consumer)
        entries[key] = entry
        if on_entry is not None:
            on_entry(name, key, entry)
        del case
    return {"version": RECORD_VERSION, "backend": backend, "impl": impl,
            "mesh": mesh_tag(mesh), "entries": entries}


def save_record(record: dict, path: str) -> None:
    """``record`` to ``path`` as sorted, indented JSON with a newline."""
    with open(path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")


def load_record(path: str) -> dict:
    """The record at ``path``; ValueError when its version is not this
    module's."""
    with open(path) as f:
        record = json.load(f)
    if record.get("version") != RECORD_VERSION:
        raise ValueError(f"{path}: tuning record version {record.get('version')!r} != "
                         f"{RECORD_VERSION}; re-run the autotuner")
    return record


def record_matches_environment(record: dict, *, mesh: Any = None, device=None) -> bool:
    """Was ``record`` tuned on the backend of ``device`` (the CPU, or a
    card of this name and SM count; default as ``backend_name``), under
    this session's impl and for ``mesh``?"""
    return (record.get("backend") == backend_name(device)
            and record.get("impl") == session_impl()
            and record.get("mesh") == mesh_tag(mesh))


def apply_record(record: dict, *, force: bool = False, mesh: Any = None,
                 precision: str | None = None, consumer: str | None = None,
                 device=None) -> dict[str, dict[str, int]]:
    """Write every recorded winner of ``precision``'s and ``consumer``'s
    entries (None: the untagged ones) through ``dispatch``: a block dict
    with ``set_block_override``, a plan with ``set_plan_override`` at the
    planner arguments it was tuned at. Raises where the record was tuned
    for another backend (``device``'s), impl or mesh, unless ``force``.
    Returns ``{op: blocks}`` applied."""
    if not force and not record_matches_environment(record, mesh=mesh, device=device):
        raise ValueError(
            f"tuning record is for backend={record.get('backend')!r} "
            f"impl={record.get('impl')!r} mesh={record.get('mesh')!r} but "
            f"this session dispatches backend={backend_name(device)!r} "
            f"impl={session_impl()!r} mesh={mesh_tag(mesh)!r}; "
            f"re-run the autotuner (or pass force=True)")
    applied = {}
    for entry in record["entries"].values():
        if entry.get("precision") != precision or entry.get("consumer") != consumer:
            continue
        blocks = {k: int(v) for k, v in entry["blocks"].items()}
        kind = entry.get("knob", "blocks")
        if kind == "fixed":
            continue
        if kind == "plan":
            args = decode_args(entry["plan_args"])
            dispatch.set_plan_override(entry["plan_op"], args,
                                       plan_of(entry["plan_op"], args, blocks))
        else:
            dispatch.set_block_override(entry["op"], **blocks)
        applied[entry["op"]] = blocks
    return applied


def record_deltas(record: dict) -> dict[str, dict]:
    """Tuned against default per entry of ``record``: ``{op[@policy][#consumer]:
    {blocks, default_blocks, us_per_call, default_us, delta_pct,
    non_default}}``, None times kept (an all-pruned entry has none)."""
    out = {}
    for entry in record["entries"].values():
        tuned, default = entry["us_per_call"], entry["default_us"]
        delta = (tuned - default) / default * 100.0 if tuned is not None and default else None
        name = entry["op"]
        if entry.get("precision"):
            name = f"{name}@{entry['precision']}"
        if entry.get("consumer"):
            name = f"{name}#{entry['consumer']}"
        out[name] = {"blocks": entry["blocks"], "default_blocks": entry["default_blocks"],
                     "us_per_call": tuned, "default_us": default, "delta_pct": delta,
                     "non_default": entry["blocks"] != entry["default_blocks"]}
    return out


def main(argv=None) -> None:
    """The command line: search ``full_suite()`` (or ``--ops``) on the
    device and write the record to ``--out``; ``argv`` defaults to
    ``sys.argv``. Prints each entry's winner against its default."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="autotune_record.json")
    ap.add_argument("--ops", default=None,
                    help=f"comma-separated subset of {sorted(full_suite())}")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--smem-budget", type=int, default=SMEM_BUDGET_BYTES,
                    help="shared memory a CTA may take, bytes (plans past it are pruned)")
    ap.add_argument("--budget", type=int, default=None, metavar="N",
                    help="time at most N candidates a case, in warm-start order "
                         "(the default always)")
    ap.add_argument("--impl", default=None, help="pin a dispatch impl for the search")
    ap.add_argument("--device", default=None, help="default cuda; cpu runs here")
    ap.add_argument("--shapes", choices=("card", "reference"), default=None,
                    help="the suite's shapes (default: card on a card, else reference)")
    ap.add_argument("--mesh", default=None, metavar="DxM|PxDxM",
                    help="tune through the sharded dispatch on this mesh of one card's streams")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh_rows import parse_mesh

        mesh = parse_mesh(args.mesh, device=device)
    subset = args.ops.split(",") if args.ops else None
    card = None if args.shapes is None else args.shapes == "card"
    with dispatch.default_impl(args.impl):
        record = autotune(subset, smem_budget=args.smem_budget, reps=args.reps,
                          trial_budget=args.budget, suite=full_suite(), mesh=mesh,
                          device=device, card=card)
    save_record(record, args.out)
    print(f"wrote {args.out}")
    for op, d in sorted(record_deltas(record).items()):
        tuned = ("n/a (all candidates pruned)" if d["us_per_call"] is None
                 else f"{d['us_per_call']:.1f}us")
        default = "n/a" if d["default_us"] is None else f"{d['default_us']:.1f}us"
        delta = "n/a" if d["delta_pct"] is None else f"{d['delta_pct']:+.1f}%"
        print(f"{op}: {d['blocks']} {tuned} (default {d['default_blocks']} {default}, "
              f"delta {delta})")


if __name__ == "__main__":
    main()
