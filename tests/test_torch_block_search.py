"""The port's block-geometry search (``repro_torch.launch.block_search``)
against the reference's autotuner (``repro.launch.autotune``) on the CPU,
and the kernels' plan seam (``hopper/dispatch.py`` plan overrides, each
planner's ``candidates``).

- Case keys: op, shapes and dtypes, policy and consumer equal to the
  reference's ``case_key(op, local_case_shapes(case, impl), ...)`` for all
  eleven ``full_suite()`` entries, without a mesh and on
  ``MeshSpec({"data": 2, "model": 4})``.
- Selection: under one injected deterministic timer the port's
  ``autotune(device="cpu")`` at the reference's shapes picks the
  reference's blocks wherever the knob sets agree (every entry but the
  scaled GEMM's, whose ``bk`` the port holds), with ties, a trial budget
  and, on a plan search, an all-pruned entry; the warm-start bytes equal
  the reference's ``traffic_bytes()``.
- The record: ``record_deltas`` equal to the reference's on one record,
  ``save_record`` byte-stable and equal to the reference's, a wrong
  version refused, and each of the reference's ``tests/test_autotune.py``
  checks of environment, precision and consumer scoping ported.
- The semantic guard: the reference's ``gemm@fp8`` candidates compute
  different functions (bk is the quantization block); the port holds bk;
  a candidate whose output differs is never chosen (a block dict) or
  raises (a kernel plan).
- The planners: ``candidates()`` holds ``plan()``'s pick as its least-cost
  feasible entry, feasible entries within the card's limits and pruned
  ones past them; a plan override holds at its exact arguments only,
  past a planner result cached before it.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import partition as jpart  # noqa: E402
from repro.kernels import registry  # noqa: E402
from repro.launch import autotune as at  # noqa: E402
from repro_torch.hopper import (dispatch, flash_attention, gemm, gemm_scaled, partition,  # noqa: E402
                                spmm, spmspm, stencil)
from repro_torch.launch import block_search as bs  # noqa: E402

NAMES = list(at.full_suite())
# entries whose CPU knob set is the reference's (the scaled GEMM holds bk)
SAME_KNOBS = [n for n in NAMES if "@" not in n]


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    registry.set_default_impl(None)
    registry.clear_block_overrides()
    dispatch.set_default_impl(None)
    dispatch.clear_block_overrides()
    dispatch.clear_plan_overrides()


def _rng():
    return np.random.default_rng(0)


def _const(case, blocks):
    return 1.0


def _timer(case, blocks):
    """Deterministic, with ties: a few blocks share a time."""
    return float((sum(blocks.values()) // 64) % 3 + 1)


def _split(key):
    """(op, shapes:dtypes, policy/consumer suffix) of a record key; the
    backend and impl fields are each package's own."""
    key, _, consumer = key.partition("#")
    fields = key.split("|")
    return fields[0], fields[1], tuple(fields[4:]), consumer


def _port_record(**kw):
    return bs.autotune(suite=bs.full_suite(), device="cpu", **kw)


def _ref_record(**kw):
    return at.autotune(suite=at.full_suite(), **kw)


@pytest.fixture(scope="module")
def keys():
    out = {}
    for tag, jmesh, tmesh in (("flat", None, None),
                              ("2x4", jpart.MeshSpec({"data": 2, "model": 4}),
                               partition.MeshSpec({"data": 2, "model": 4}))):
        ref = list(_ref_record(mesh=jmesh, time_candidate=_const)["entries"])
        port = list(_port_record(mesh=tmesh, time_candidate=_const)["entries"])
        out[tag] = dict(zip(NAMES, zip(ref, port)))
    return out


@pytest.mark.parametrize("mesh", ["flat", "2x4"])
@pytest.mark.parametrize("name", NAMES)
def test_case_keys_match_reference(keys, mesh, name):
    ref, port = keys[mesh][name]
    assert _split(port) == _split(ref)
    assert port.split("|")[2] == "cpu"


def test_motivating_keys():
    mesh = partition.MeshSpec({"data": 2, "model": 4})
    rec = _port_record(mesh=mesh, time_candidate=_const,
                       ops_subset=["gemm", "stencil", "flash_attention#decode"])
    shapes = {_split(k)[1] for k in rec["entries"]}
    assert {"256x64:float32,64x256:float32", "16x32x32:float32",
            "1x1x1x64:float32,1x1x256x64:float32,1x1x256x64:float32"} == shapes
    assert rec["mesh"] == "2x4"


@pytest.mark.parametrize("name", SAME_KNOBS)
def test_traffic_equals_reference_stream_bytes(name):
    jcase = at.full_suite()[name](_rng())
    tcase = bs.full_suite()[name](_rng(), device="cpu")
    defaults = registry.block_defaults(jcase.op, overrides=False)
    for cand in [{}] + jcase.candidates:
        full = {**defaults, **cand}
        assert tcase.traffic(full) == jcase.program(full).traffic_bytes(), full


@pytest.mark.parametrize("budget", [None, 1, 2])
@pytest.mark.parametrize("timer", [_const, _timer])
def test_selection_matches_reference(timer, budget):
    ref = _ref_record(time_candidate=timer, trial_budget=budget)["entries"]
    port = _port_record(time_candidate=timer, trial_budget=budget)["entries"]
    for name, (rk, pk) in zip(NAMES, zip(ref, port)):
        r, p = ref[rk], port[pk]
        if name not in SAME_KNOBS:
            continue
        assert p["blocks"] == r["blocks"], name
        assert p["us_per_call"] == r["us_per_call"], name
        assert p["default_us"] == r["default_us"], name
        assert [t["blocks"] for t in p["timed"]] == [t["blocks"] for t in r["timed"]], name
        assert [s["blocks"] for s in p["skipped_by_budget"]] == \
            [s["blocks"] for s in r["skipped_by_budget"]], name
        if timer is _const:  # ties keep the default
            assert p["blocks"] == p["default_blocks"], name
        if budget is not None:  # the budget keeps the default timed
            assert any(t["blocks"] == p["default_blocks"] for t in p["timed"]), name


def test_default_is_timed_first_and_last():
    calls = []

    def timer(case, blocks):
        calls.append(dict(blocks))
        return {32: 6.0, 64: 4.0, 128: 5.0, 256: 4.5}[blocks["bm"]] - 0.1 * len(calls)

    case = bs.DEFAULT_SUITE["spmm"](_rng(), device="cpu")
    e = bs.autotune_case(case, time_candidate=timer)
    assert calls[0] == calls[-1] == e["default_blocks"] and len(calls) == 5
    assert len(e["default_readings_us"]) == 2
    assert e["default_us"] == min(e["default_readings_us"])
    # a candidate counts only against the better default reading
    assert e["us_per_call"] <= e["default_us"]


def test_record_deltas_equal_reference():
    record = _ref_record(time_candidate=_timer)
    for e in record["entries"].values():
        e["us_per_call"], e["default_us"] = 50.0, 100.0
    assert bs.record_deltas(record) == at.record_deltas(record)


def test_save_record_byte_stable_and_equal_reference(tmp_path):
    record = _port_record(time_candidate=_timer)
    a, b, j = (str(tmp_path / n) for n in ("a.json", "b.json", "j.json"))
    bs.save_record(record, a)
    bs.save_record(bs.load_record(a), b)
    at.save_record(json.loads(open(a).read()), j)
    assert open(a, "rb").read() == open(b, "rb").read() == open(j, "rb").read()


# ---------------------------------------------------------------------------
# The reference's tests/test_autotune.py checks, ported
# ---------------------------------------------------------------------------


def test_smem_bytes_arithmetic():
    # csrc/gemm.cu f_smem_bytes: B resident (K rows of 48 wc) + ring stages of A
    assert gemm.smem_bytes(4, 2, 2, 144, 3, True) == 4 * (3 * 64 * 20 + 144 * 96)
    assert gemm.smem_bytes(4, 2, 2, 144, 3, False) == 4 * 3 * (64 * 20 + 16 * 96)
    # csrc/flash_attention.cu wg_smem_bytes<D, NWG>: (NWG + 4) 64 x D bf16 tiles + 1 KB
    assert flash_attention.wg_smem_bytes(256, 2) == 6 * 64 * 256 * 2 + 1024
    # csrc/gemm_scaled.cu w_smem_bytes
    assert gemm_scaled.wgmma_smem_bytes(6) == 6 * 32768 + 1024 + 96 + 8192


def test_plan_search_prunes_before_timing():
    case = bs.DEFAULT_SUITE["gemm"](_rng(), device="cpu")
    timed = []

    def fake(case_, blocks):
        timed.append(dict(blocks))
        return 1.0

    budget = 60_000
    e = bs.autotune_case(case, knob="plan", smem_budget=budget, time_candidate=fake)
    # two ring stages pass the budget, or the SM's share at its CTAs an SM
    room = {id(p): min(budget, gemm.SMEM_PER_SM // p["blocks"]["ctas"] - 1024)
            for p in e["pruned"]}
    assert e["pruned"] and all(p["smem_bytes"] > room[id(p)] or p["why"] != "shared memory"
                               for p in e["pruned"])
    assert any(p["smem_bytes"] > budget for p in e["pruned"])
    pruned = [p["blocks"] for p in e["pruned"]]
    assert not any(t in pruned for t in timed)
    assert all(c.smem <= budget for c in gemm.candidates(256, 256, 256, 132, True,
                                                         smem_budget=budget) if c.feasible)


def test_selection_never_worse_than_default():
    case = bs.DEFAULT_SUITE["gemm"](_rng(), device="cpu")
    e = bs.autotune_case(case, time_candidate=lambda c, b: float(1000 - b["bm"]))
    assert e["blocks"] == e["default_blocks"] and e["us_per_call"] == e["default_us"]
    e = bs.autotune_case(case, time_candidate=lambda c, b: float(b["bm"]))
    assert e["blocks"]["bm"] == 64 and e["us_per_call"] <= e["default_us"]


def test_search_restores_overrides():
    case = bs.DEFAULT_SUITE["gemm"](_rng(), device="cpu")
    dispatch.set_block_override("gemm", bm=128)
    bs.autotune_case(case, time_candidate=_const)
    assert dispatch.block_defaults("gemm")["bm"] == 128
    bs.autotune_case(case, knob="plan", time_candidate=_const)
    assert dispatch._plan_overrides == {}


def _toy_record():
    rng = _rng()
    entries = {}
    for name in ("gemm", "flash_attention"):
        case = bs.DEFAULT_SUITE[name](rng, device="cpu")
        entries[bs.case_key(case.op, case.args, "cpu", "auto")] = bs.autotune_case(
            case, time_candidate=lambda c, b: float(sum(b.values())))
    return {"version": bs.RECORD_VERSION, "backend": "cpu", "impl": "auto", "mesh": None,
            "entries": entries}


def test_record_roundtrip_applies_same_selections(tmp_path):
    record = _toy_record()
    path = str(tmp_path / "rec.json")
    bs.save_record(record, path)
    loaded = bs.load_record(path)
    assert loaded == json.loads(json.dumps(record))
    applied = bs.apply_record(loaded, device="cpu")
    assert applied == {e["op"]: e["blocks"] for e in record["entries"].values()}
    for e in record["entries"].values():
        assert dispatch.block_defaults(e["op"]) == e["blocks"]


def test_plan_record_roundtrip_sets_the_plan_at_its_arguments(tmp_path):
    case = bs.DEFAULT_SUITE["stencil"](_rng(), device="cpu")
    e = bs.autotune_case(case, knob="plan", time_candidate=lambda c, b: float(-b["runs"]))
    assert e["knob"] == "plan" and e["blocks"] != e["default_blocks"]
    record = {"version": bs.RECORD_VERSION, "backend": "cpu", "impl": "auto", "mesh": None,
              "entries": {"k": e}}
    path = str(tmp_path / "rec.json")
    bs.save_record(record, path)
    bs.apply_record(bs.load_record(path), device="cpu")
    args = bs.decode_args(e["plan_args"])
    want = bs.plan_of("stencil", args, e["blocks"])
    hits = dispatch.PLAN_HITS["stencil"]
    assert stencil.plan(*args) == want and dispatch.PLAN_HITS["stencil"] == hits + 1
    shape, red, sms = args
    assert stencil.plan((shape[0] * 2,) + shape[1:], red, sms) != want  # another shape: the model


def test_apply_record_rejects_foreign_environment():
    record = _toy_record()
    record["backend"] = "NVIDIA H100 80GB HBM3 (132 SMs)"
    with pytest.raises(ValueError, match="re-run the autotuner"):
        bs.apply_record(record, device="cpu")
    assert dispatch.block_defaults("gemm") == dispatch.block_defaults("gemm", overrides=False)
    bs.apply_record(record, force=True, device="cpu")


def test_autotune_rejects_unknown_ops_subset():
    with pytest.raises(KeyError, match="unknown autotune ops"):
        bs.autotune(["gemmm"], suite=bs.DEFAULT_SUITE, device="cpu")


def test_all_pruned_entry_survives_reporting():
    case = bs.DEFAULT_SUITE["gemm"](_rng(), device="cpu")
    e = bs.autotune_case(case, knob="plan", smem_budget=1, time_candidate=_const)
    assert e["timed"] == [] and e["us_per_call"] is None
    assert e["blocks"] == e["default_blocks"]
    record = {"version": bs.RECORD_VERSION, "backend": "cpu", "impl": "auto",
              "entries": {"k": e}}
    d = bs.record_deltas(record)
    assert d["gemm"]["us_per_call"] is None and d["gemm"]["delta_pct"] is None


def test_load_record_rejects_unknown_version(tmp_path):
    record = _toy_record()
    record["version"] = 99
    path = str(tmp_path / "bad.json")
    bs.save_record(record, path)
    with pytest.raises(ValueError, match="version"):
        bs.load_record(path)


def test_record_deltas_math():
    record = _toy_record()
    for e in record["entries"].values():
        e["us_per_call"], e["default_us"] = 50.0, 100.0
        if "bm" in e["default_blocks"]:
            e["blocks"] = dict(e["default_blocks"], bm=1)
    deltas = bs.record_deltas(record)
    assert all(d["delta_pct"] == -50.0 for d in deltas.values())
    assert deltas["gemm"]["non_default"]


def test_case_key_is_shape_and_dtype_specific():
    k1 = bs.case_key("gemm", (torch.zeros(4, 8),), "cpu", "auto")
    k2 = bs.case_key("gemm", (torch.zeros(4, 8, dtype=torch.bfloat16),), "cpu", "auto")
    assert k1 != k2 and "4x8" in k1 and "float32" in k1 and "bfloat16" in k2
    assert k1 == bs.case_key("gemm", (((4, 8), torch.float32),), "cpu", "auto")


def _mesh_2x4():
    return partition.MeshSpec({"data": 2, "model": 4})


def test_record_keys_by_local_shard_geometry():
    rec = bs.autotune(["gemm"], mesh=_mesh_2x4(), time_candidate=_const, device="cpu")
    (key,) = rec["entries"]
    assert "256x64" in key and "64x256" in key and "256x256" not in key
    assert rec["mesh"] == "2x4"
    flat = bs.autotune(["gemm"], time_candidate=_const, device="cpu")
    (key_flat,) = flat["entries"]
    assert "256x256" in key_flat and flat["mesh"] is None and key != key_flat


def test_mesh_keys_ops_with_plan_kwargs():
    rec = bs.autotune(["bsr_spmm", "spmspm", "stencil"], mesh=_mesh_2x4(),
                      time_candidate=_const, device="cpu")
    by_op = {k.split("|")[0]: k for k in rec["entries"]}
    assert by_op["stencil"].split("|")[1].startswith("16x32x32")
    assert "32x" in by_op["spmspm"] and "128x" in by_op["spmspm"]


def test_local_case_shapes_replicated_plan_matches_flat_key():
    case = bs.DEFAULT_SUITE["flash_attention"](_rng(), device="cpu")
    case.mesh = _mesh_2x4()
    case.args = tuple(torch.zeros(1, 5, 63, 16) for _ in range(3))
    shapes = bs.local_case_shapes(case, "torch")
    assert [s for s, _ in shapes] == [tuple(a.shape) for a in case.args]


def test_local_case_shapes_ring_plan_keys_by_seq_shard():
    case = bs.DEFAULT_SUITE["flash_attention"](_rng(), device="cpu")
    case.mesh = _mesh_2x4()
    assert [s for s, _ in bs.local_case_shapes(case, "torch")] == [(1, 1, 128, 64)] * 3


def test_record_matches_environment_is_mesh_aware():
    record = _toy_record()
    assert bs.record_matches_environment(record, device="cpu")
    assert not bs.record_matches_environment(record, mesh=_mesh_2x4(), device="cpu")
    with pytest.raises(ValueError, match="re-run the autotuner"):
        bs.apply_record(record, mesh=_mesh_2x4(), device="cpu")
    record["mesh"] = "2x4"
    assert bs.record_matches_environment(record, mesh=_mesh_2x4(), device="cpu")
    bs.apply_record(record, mesh=_mesh_2x4(), device="cpu")
    assert not bs.record_matches_environment(record, device="cpu")


def test_precision_entries_never_collide_with_legacy():
    rec = bs.autotune(["gemm", "gemm@fp8", "gemm@bf16"], suite=bs.full_suite(),
                      time_candidate=_const, device="cpu")
    keys = sorted(rec["entries"])
    legacy = [k for k in keys if not k.endswith(("|fp8", "|bf16"))]
    assert len(keys) == 3 and len(legacy) == 1
    assert all(k.rsplit("|", 1)[0] == legacy[0] for k in keys if k not in legacy)
    assert {e["precision"] for e in rec["entries"].values()} == {None, "fp8", "bf16"}
    assert {"gemm", "gemm@fp8", "gemm@bf16"} <= set(bs.record_deltas(rec))


def test_apply_record_never_cross_applies_policies():
    rec = bs.autotune(["gemm", "gemm@fp8", "gemm@bf16"], suite=bs.full_suite(),
                      time_candidate=_const, device="cpu")
    want = {None: 256, "fp8": 64, "bf16": 128}
    for e in rec["entries"].values():
        e["blocks"] = dict(e["blocks"], bm=want[e["precision"]])
    for pol, bm in want.items():
        dispatch.clear_block_overrides()
        applied = bs.apply_record(rec, precision=pol, device="cpu")
        assert set(applied) == {"gemm"} and applied["gemm"]["bm"] == bm
        assert dispatch.block_defaults("gemm")["bm"] == bm


def test_consumer_entries_never_collide():
    rec = bs.autotune(["decode_attention", "decode_attention#decode", "flash_attention#prefill",
                       "flash_attention#decode"], suite=bs.full_suite(), time_candidate=_const,
                      device="cpu")
    keys = sorted(rec["entries"])
    assert len(keys) == 4
    da = [k for k in keys if k.startswith("decode_attention")]
    tagged = next(k for k in da if k.endswith("#decode"))
    assert tagged == next(k for k in da if k != tagged) + "#decode"
    fa = [k for k in keys if k.startswith("flash_attention")]
    assert {k.rsplit("#", 1)[1] for k in fa} == {"prefill", "decode"}
    assert {e["consumer"] for e in rec["entries"].values()} == {None, "prefill", "decode"}


def test_apply_record_never_cross_applies_consumers():
    rec = bs.autotune(["decode_attention", "decode_attention#decode"], suite=bs.full_suite(),
                      time_candidate=_const, device="cpu")
    want = {None: 1024, "decode": 128}
    for e in rec["entries"].values():
        e["blocks"] = dict(e["blocks"], bs=want[e["consumer"]])
    for consumer, bsz in want.items():
        dispatch.clear_block_overrides()
        applied = bs.apply_record(rec, consumer=consumer, device="cpu")
        assert set(applied) == {"decode_attention"} and applied["decode_attention"]["bs"] == bsz
        assert dispatch.block_defaults("decode_attention")["bs"] == bsz


def test_records_without_consumer_field_apply_as_untagged():
    rec = bs.autotune(["decode_attention"], suite=bs.full_suite(), time_candidate=_const,
                      device="cpu")
    for e in rec["entries"].values():
        del e["consumer"]
    assert set(bs.apply_record(rec, device="cpu")) == {"decode_attention"}
    dispatch.clear_block_overrides()
    assert bs.apply_record(rec, consumer="decode", device="cpu") == {}


# ---------------------------------------------------------------------------
# The semantic guard
# ---------------------------------------------------------------------------


def test_reference_fp8_candidates_are_different_functions():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    outs = {}
    for bk in (64, 256):
        with registry.block_override("gemm", bm=bk, bk=bk, bn=bk):
            outs[bk] = np.asarray(jops.gemm(a, b, precision="fp8", impl="xla"))
    assert np.abs(outs[64] - outs[256]).max() > 1.0


@pytest.mark.parametrize("name", ["gemm@fp8", "gemm@bf16"])
def test_port_holds_the_quantization_block(name):
    e = bs.autotune([name], suite=bs.full_suite(), time_candidate=_timer,
                    device="cpu")["entries"]
    (e,) = e.values()
    assert e["blocks"]["bk"] == 256
    assert all(t["blocks"]["bk"] == 256 for t in e["timed"])
    case = bs.full_suite()[name](_rng(), device="cpu")
    pe = bs.autotune_case(case, knob="plan", time_candidate=_const)
    assert bs.decode_args(pe["plan_args"])[3] == 256  # the planner's bk: the default


def test_a_differing_candidate_is_never_chosen():
    case = bs.DEFAULT_SUITE["spmm"](_rng(), device="cpu")

    def run(case_, blocks):
        out = case_.fn(*case_.args)
        return out + 1.0 if blocks["bm"] == 64 else out

    e = bs.autotune_case(case, time_candidate=lambda c, b: float(b["bm"]), run_candidate=run)
    assert [m["blocks"]["bm"] for m in e["mismatched"]] == [64]
    assert e["blocks"]["bm"] == 32

    def run_plan(case_, blocks):
        out = case_.fn(*case_.args)
        return out if blocks == e_plan_default else out.clone().add_(1e-3)

    e_plan_default = dispatch.model_pick(spmm.candidates(512, 13, 256, 64, 4, True)).knobs
    with pytest.raises(bs.SearchFault, match="gives another output"):
        bs.autotune_case(case, knob="plan", time_candidate=_const, run_candidate=run_plan)


def test_checked_outputs_agree_for_every_cpu_candidate():
    rec = bs.autotune(suite=bs.full_suite(), device="cpu", reps=1)
    for e in rec["entries"].values():
        assert e["mismatched"] == [], e["op"]
        assert all("checksum" in t for t in e["timed"])


# ---------------------------------------------------------------------------
# The planners
# ---------------------------------------------------------------------------

PLANNERS = {
    "gemm": (gemm.candidates, gemm.plan_f32,
             [(169343, 144, 144, 132, True), (2708, 144, 144, 132, True),
              (1000, 1024, 2048, 132, False), (5, 1, 100000, 132, True)]),
    "gemm_scaled": (gemm_scaled.candidates, gemm_scaled.plan,
                    [(2048, 16384, 4096, 256, torch.bfloat16, True, 132),
                     (2048, 16384, 4096, 256, torch.float8_e4m3fn, True, 132),
                     (300, 500, 700, 128, torch.float32, True, 132),
                     (30, 500, 700, 128, torch.bfloat16, True, 132)]),
    "spmm": (spmm.candidates, spmm.plan,
             [(169343, 15, 169343, 144, 4, True), (8192, 459, 16384, 256, 4, True),
              (100, 3, 50, 33, 2, False), (46638, 0, 120845, 750, 4, True)]),
    "spmspm": (spmspm.candidates, spmspm.plan,
               [(4096, 4096, 164, 16384), (10, 300000, 7, 40000), (1, 5, 0, 3)]),
    "stencil": (stencil.candidates, stencil.plan,
                [stencil.plan_args((512, 512, 512), bs.BOX27, 132),
                 stencil.plan_args((8192, 8192, 1), np.array([[0, 4, 0]]), 132),
                 stencil.plan_args((64, 32, 32), np.array([[9, 0, 0]]), 132)]),
    "flash_attention": (flash_attention.candidates, flash_attention.plan,
                        [(1, 16, 512, 256, torch.bfloat16, 132),
                         (4, 16, 2048, 128, torch.bfloat16, 132),
                         (1, 16, 1, 256, torch.bfloat16, 132),
                         (2, 8, 100, 64, torch.float32, 132)]),
}
LIMITS = {"gemm": (gemm.SMEM_PER_CTA, gemm.MAX_THREADS), "gemm_scaled": (gemm.SMEM_PER_CTA, 384),
          "spmm": (0, spmm.THREADS), "spmspm": (4 * spmspm.WARPS * spmspm.CT_MAX, 128),
          "stencil": (stencil.MAX_SMEM, stencil.THREADS),
          "flash_attention": (flash_attention.SMEM_PER_CTA, 256)}


@pytest.mark.parametrize("op", list(PLANNERS))
def test_candidates_hold_the_planners_pick(op):
    cands_fn, plan_fn, cases = PLANNERS[op]
    smem, threads = LIMITS[op]
    for args in cases:
        cands = cands_fn(*args)
        feasible = [c for c in cands if c.feasible]
        pick = dispatch.model_pick(cands)
        assert plan_fn(*args) == pick.plan, args
        assert all(pick.key <= c.key for c in feasible), args
        assert all(c.smem <= smem and c.threads <= threads for c in feasible), args
        for c in cands:
            if not c.feasible:
                assert c.why in ("shared memory", "threads", "registers", "grid", "ring",
                                 "cells a thread"), c
                if c.why == "shared memory":
                    assert c.smem > smem or op in ("gemm", "stencil"), c


def test_fa_model_is_the_kernels_rule():
    for B in (1, 2, 4):
        for H in (1, 8, 16, 40):
            for Sq in (1, 64, 65, 512, 2048, 8192):
                ctas = -(-Sq // 64) * H * B
                want = 2 if ctas > 132 else 1
                assert flash_attention.plan(B, H, Sq, 256, torch.bfloat16, 132) == want


@pytest.mark.parametrize("op", ["gemm", "gemm_scaled"])
def test_override_holds_at_its_arguments_past_the_cache(op):
    cands_fn, plan_fn, cases = PLANNERS[op]
    args, other = cases[0], cases[1]
    model = plan_fn(*args)  # cached now
    alt = next(c.plan for c in cands_fn(*args) if c.feasible and c.plan != model)
    with dispatch.plan_override(op, args, alt):
        assert plan_fn(*args) == alt
        assert plan_fn(*other) == dispatch.model_pick(cands_fn(*other)).plan
    assert plan_fn(*args) == model  # the scope ended: the cached pick again
    dispatch.set_plan_override(op, args, alt)
    assert plan_fn(*args) == alt
    dispatch.clear_plan_overrides(op)
    assert plan_fn(*args) == model


def test_block_search_cli_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "r.json")
    bs.main(["--device", "cpu", "--out", out, "--reps", "1", "--ops", "gemm,stencil,spmm"])
    rec = bs.load_record(out)
    assert rec["backend"] == "cpu" and len(rec["entries"]) == 3
    assert "wrote" in capsys.readouterr().out
