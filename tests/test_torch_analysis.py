"""repro_torch.analysis: the rule inventory against the reference's, every
AST rule firing on its seeded fixture, the plan tier's helpers giving the
reference's problem strings on the same seeded-bad artifacts, the
``smem-budget`` rule and the kernels' ``KernelStreams`` declarations held
to the plain forms' tensors, and the port's tree clean."""
import json
import pathlib
import shutil

import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the `cuda`-marked test runs there
    import jax  # noqa: F401
    from repro.analysis import plan_rules as ref_plan
    from repro.analysis import registered_rules as ref_registered_rules
    from repro.analysis import run_rules as ref_run_rules
except ImportError:
    ref_plan = ref_registered_rules = ref_run_rules = None

from repro_torch.analysis import base, cli, plan_rules, registered_rules, run_rules  # noqa: E402
from repro_torch.analysis.model_rules import check_dtype_dataflow  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.hopper import blocked, build, dispatch, ops, ring_hop  # noqa: E402
from repro_torch.hopper.dispatch import KernelStreams, StreamOperand  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "torch_analysis_fixtures"


@pytest.fixture(scope="module")
def full_run():
    """Every port rule once over the real tree: (findings, stats)."""
    stats = {}
    return run_rules(stats=stats), stats


# ---------------------------------------------------------------------------
# Inventory
# ---------------------------------------------------------------------------


def test_inventory_maps_every_reference_rule():
    ref = {r.name: r.tier for r in ref_registered_rules()}
    port = {r.name: r for r in registered_rules()}
    assert set(base.REFERENCE_COUNTERPARTS) == set(ref)
    mapped = {}
    for name, counterpart in base.REFERENCE_COUNTERPARTS.items():
        if counterpart in port:
            assert port[counterpart].tier == ref[name], name
            mapped[counterpart] = name
        else:
            assert counterpart.startswith("no counterpart: "), (name, counterpart)
    assert set(mapped) == set(port), "every port rule stands for a reference rule"
    assert len(port) == 15 and len(ref) == 16
    assert base.REFERENCE_COUNTERPARTS["xla-flags-append-only"].startswith("no counterpart")
    assert base.REFERENCE_COUNTERPARTS["vmem-budget"] == "smem-budget"
    assert all(r.doc for r in port.values()), "every rule carries a --list summary"
    assert len(registered_rules()) == len(port)  # unique names


def test_unknown_rule_raises():
    with pytest.raises(KeyError, match="unknown rules"):
        run_rules(["not-a-rule"])


# ---------------------------------------------------------------------------
# AST tier: each rule fires on its seeded fixture
# ---------------------------------------------------------------------------

AST_FIXTURE_CASES = [
    ("single-launch-site", "launch_site", 4, "no hopper/ kernel module loads it"),
    ("block-geometry-registry-only", "block_geometry", 5, "bk=512"),
    ("no-environ-in-kernels", "environ", 3, "os.getenv"),
    ("axis-name-vocabulary", "axis_vocab", 3, "'rows'"),
    ("docstring-contract", "docstring", 4, "missing or trivial docstring"),
    ("warn-category", "warncat", 2, "explicit category"),
]


@pytest.mark.parametrize("rule,subdir,count,needle", AST_FIXTURE_CASES,
                         ids=[c[0] for c in AST_FIXTURE_CASES])
def test_rule_fires_on_fixture(rule, subdir, count, needle):
    findings = run_rules([rule], root=FIXTURES / subdir)
    assert len(findings) == count, [f.format() for f in findings]
    assert all(f.rule == rule for f in findings)
    assert any(needle in f.message for f in findings), [f.message for f in findings]


def test_rules_stay_in_their_lane():
    ast_names = [r.name for r in registered_rules() if r.tier == "ast"]
    for rule, subdir, *_ in AST_FIXTURE_CASES:
        findings = run_rules([n for n in ast_names if n != rule], root=FIXTURES / subdir)
        assert findings == [], [f.format() for f in findings]


def test_launch_site_findings_name_each_seeded_fault():
    got = {(f.path, f.line): f.message
           for f in run_rules(["single-launch-site"], root=FIXTURES / "launch_site")}
    assert "opens a shared library" in got[("launch/warmup.py", 13)]
    assert "build.load outside" in got[("launch/warmup.py", 12)]
    assert "loaded by 2 modules" in got[("hopper/gemm_twin.py", 0)]
    assert "'spmm'" in got[("hopper/build.py", 0)]


def test_environ_exemption_is_build_py_cuda_home_only(tmp_path):
    hopper = tmp_path / "hopper"
    hopper.mkdir()
    (hopper / "build.py").write_text(
        "import os\n\n\ndef nvcc():\n    return os.environ.get('CUDA_HOME', '/usr/local/cuda')\n")
    assert run_rules(["no-environ-in-kernels"], root=tmp_path) == []
    (hopper / "gemm.py").write_text(
        "import os\n\n\ndef home():\n    return os.environ.get('CUDA_HOME')\n")
    (hopper / "build.py").write_text(
        "import os\n\n\ndef nvcc():\n    return os.getenv('CUDA_HOME'), os.environ['CUDA_PATH']\n")
    findings = run_rules(["no-environ-in-kernels"], root=tmp_path)
    assert sorted((f.path, f.line) for f in findings) == [
        ("hopper/build.py", 5), ("hopper/gemm.py", 5)], [f.format() for f in findings]


def test_real_build_sources_are_each_loaded_once(tmp_path):
    """The real hopper/ tree: every build.SOURCES library has one loader; a
    copy with one loader removed reports that library."""
    src = pathlib.Path(build.__file__).parent
    shutil.copytree(src, tmp_path / "hopper", ignore=shutil.ignore_patterns("__pycache__"))
    assert run_rules(["single-launch-site"], root=tmp_path) == []
    path = tmp_path / "hopper" / "stencil.py"
    path.write_text(path.read_text().replace('build.load("stencil")', "None"))
    findings = run_rules(["single-launch-site"], root=tmp_path)
    assert [f.message for f in findings] == [
        "build.SOURCES names 'stencil' but no hopper/ kernel module loads it"]


def test_parse_error_reported_not_raised(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    findings = run_rules(["single-launch-site"], root=tmp_path)
    assert [f.rule for f in findings] == ["parse-error"]


@pytest.fixture(scope="module")
def reference_on_port_fixtures(tmp_path_factory):
    """The reference's analyzer, run once, over the port's warn-category
    fixture and its docstring fixture at the reference's documented paths."""
    root = tmp_path_factory.mktemp("ref_root")
    shutil.copy(FIXTURES / "warncat" / "degrade.py", root / "degrade.py")
    for src, dst in (("hopper/partition.py", "kernels/partition.py"),
                     ("launch/block_search.py", "launch/autotune.py")):
        (root / dst).parent.mkdir(exist_ok=True)
        shutil.copy(FIXTURES / "docstring" / src, root / dst)
    return ref_run_rules(["warn-category", "docstring-contract"], root=root)


def test_shared_ast_rules_match_the_reference_on_the_same_input(reference_on_port_fixtures):
    ref = sorted((f.rule, f.line, f.message) for f in reference_on_port_fixtures)
    port = sorted((f.rule, f.line, f.message)
                  for d, rule in (("warncat", "warn-category"), ("docstring", "docstring-contract"))
                  for f in run_rules([rule], root=FIXTURES / d))
    assert port == ref and len(port) == 6


# ---------------------------------------------------------------------------
# Plan tier: the reference's problem strings on the same seeded-bad inputs
# ---------------------------------------------------------------------------


def _hop_cases(E):
    return {
        "alias hazard": ((E("send", 1, 0, 0), E("fold", 0, 0), E("fold", 1, 0)), 2, False),
        "unwaited dma": ((E("dma_start", 1, 0, 1), E("fold", 0, 0), E("fold", 1, 1),
                          E("dma_wait", 1, None, 1)), 2, True),
        "coverage": ((E("fold", 0, 0),), 2, False),
        "fold order": ((E("send", 1, 0, 1), E("fold", 1, 1), E("fold", 0, 0)), 2, False),
        "stale send": ((E("send", 2, 1, 0), E("fold", 0, 0)), 1, False),
    }


NEEDLES = {"alias hazard": "alias hazard", "unwaited dma": "before its DMA semaphore wait",
           "coverage": "do not cover", "fold order": "fold order broken",
           "stale send": "expected hop 1"}


@pytest.mark.parametrize("case", sorted(NEEDLES))
def test_hop_schedule_problems_equal_the_reference(case):
    from repro.parallel.collectives import HopEvent as RefEvent

    from repro_torch.parallel.collectives import HopEvent

    events, hops, remote = _hop_cases(HopEvent)[case]
    ref_events, _, _ = _hop_cases(RefEvent)[case]
    got = plan_rules.check_hop_schedule(events, hops, remote_copy=remote)
    assert got == ref_plan.check_hop_schedule(ref_events, hops, remote_copy=remote)
    assert any(NEEDLES[case] in p for p in got), got


def test_hop_schedule_clean_on_every_real_schedule():
    from repro_torch.parallel.collectives import ring_schedule

    for hops in (1, 2, 3, 8):
        for overlap in (False, True):
            for remote in (False, True):
                ev = ring_schedule(hops, overlap=overlap, remote_copy=remote)
                assert plan_rules.check_hop_schedule(ev, hops, remote_copy=remote) == []


def test_mesh_cases_problems_equal_the_reference():
    from repro.launch.op_cases import op_roofline_cases as ref_cases

    from repro_torch.launch.op_cases import op_roofline_cases

    port = [c for c in op_roofline_cases() if c[0] == "gemm"]
    ref = [c for c in ref_cases() if c[0] == "gemm"]
    got = plan_rules.check_mesh_cases(port, {"model": 5})
    assert got == ref_plan.check_mesh_cases(ref, {"model": 5})
    assert any("ladder dead-end" in p for p in got), got
    assert plan_rules.check_mesh_cases(port, {"data": 16, "model": 16}) == []


def test_plan_problems_equal_the_reference_and_kinds_are_the_priced_ones():
    import ast
    import inspect

    from repro.kernels.partition import CollectiveCost as RefCost
    from repro.kernels.partition import PartitionPlan as RefPlan

    from repro_torch.core import topology
    from repro_torch.hopper.partition import CollectiveCost, PartitionPlan

    def bogus(Plan, Cost):
        return Plan(op="bogus", levels=(("rows", 4),), in_specs=(), out_specs=None,
                    local_fn=lambda *a: None, collectives=(Cost("gossip", "rows", -1, n=4),),
                    overlappable=True, hops=1)

    got = plan_rules.check_plan(bogus(PartitionPlan, CollectiveCost), {"data": 16, "model": 16})
    want = ref_plan.check_plan(bogus(RefPlan, RefCost), {"data": 16, "model": 16})
    # the port's priceable kinds add all_to_all (core/topology.py prices it)
    known = f"(known: {sorted(plan_rules.COLLECTIVE_KINDS)})"
    assert got == [p.replace(f"(known: {sorted(ref_plan.COLLECTIVE_KINDS)})", known) for p in want]
    for needle in ("outside AXIS_VOCAB", "not priceable", "negative nbytes", "hops=1"):
        assert any(needle in p for p in got), (needle, got)
    # COLLECTIVE_KINDS is exactly what launch/roofline.py's pricing knows:
    # the kinds core/topology.py's collective_seconds compares ``kind`` to
    priced = set()
    for node in ast.walk(ast.parse(inspect.getsource(topology.collective_seconds))):
        if isinstance(node, ast.Compare) and getattr(node.left, "id", None) == "kind":
            for c in node.comparators:
                elts = c.elts if isinstance(c, ast.Tuple) else [c]
                priced |= {e.value for e in elts if isinstance(e, ast.Constant)}
    assert priced == set(plan_rules.COLLECTIVE_KINDS)
    for kind in plan_rules.COLLECTIVE_KINDS:
        topology.collective_seconds(kind, 1024.0, "model", 4)
    with pytest.raises(ValueError):
        topology.collective_seconds("gossip", 1024.0, "model", 4)


def _serving_sched(pkg, **kw):
    sched_mod = pytest.importorskip(f"{pkg}.serving.scheduler")
    defaults = dict(num_blocks=9, block_size=4, max_slots=3, max_blocks_per_seq=6)
    defaults.update(kw)
    sched = sched_mod.ContinuousBatchingScheduler(**defaults)
    for rid in range(6):
        sched.submit(sched_mod.Request(rid=rid, prompt=(1, 2, 3), max_new_tokens=5,
                                       arrival=rid % 3))
    return sched, sched_mod


def _tok(seq, step):
    return (seq.generated[-1] + 1) % 17 if seq.generated else 1


def _corrupt(kind, sched, mod):
    if kind == "missing growth":
        sched.ensure_block = lambda seq, step: True
    elif kind == "null block":
        orig = sched.allocator.alloc

        def alloc(rid, n):
            got = orig(rid, n)
            if got and rid == 2:
                got[0] = mod.NULL_BLOCK
            return got

        sched.allocator.alloc = alloc
    elif kind == "double ownership":
        orig_admit = sched.admit

        def admit(step):
            admitted = orig_admit(step)
            running = list(sched.running.values())
            if len(running) >= 2:
                running[1].blocks[0] = running[0].blocks[0]
            return admitted

        sched.admit = admit


PAGED_NEEDLES = {"honest": None, "missing growth": "covers only", "null block": "NULL_BLOCK",
                 "double ownership": "owned by both"}


@pytest.mark.parametrize("kind", sorted(PAGED_NEEDLES))
def test_paged_coverage_problems_equal_the_reference(kind):
    problems = {}
    for pkg, check in (("repro", ref_plan.check_paged_coverage),
                       ("repro_torch", plan_rules.check_paged_coverage)):
        sched, mod = _serving_sched(pkg)
        _corrupt(kind, sched, mod)
        problems[pkg] = check(sched, _tok)
    assert problems["repro_torch"] == problems["repro"]
    needle = PAGED_NEEDLES[kind]
    if needle is None:
        assert problems["repro_torch"] == []
    else:
        assert any(needle in p or "!= allocator ledger" in p
                   for p in problems["repro_torch"]), problems


# ---------------------------------------------------------------------------
# smem-budget: the kernels' run-time plans against a CTA's limits
# ---------------------------------------------------------------------------


def test_every_planned_suite_case_fits(full_run):
    findings, stats = full_run
    s = stats["smem-budget"]
    limits = s["limits"]
    assert limits["sms"] == 132 and limits["smem_per_block"] == 232448
    planned = {k: v for k, v in s.items() if k not in ("limits", "unplanned")}
    assert set(planned) == {"gemm", "gemm@bf16", "gemm@fp8", "flash_attention",
                            "flash_attention#prefill", "flash_attention#decode", "spmm",
                            "spmspm", "stencil"}
    for name, e in planned.items():
        assert e["feasible"] >= 1 and e["smem"] <= limits["smem_per_block"], name
        assert e["threads"] <= 1024 and e["threads"] * e["regs"] <= 65536, name
    assert s["unplanned"]["bsr_spmm"].startswith("fixed: ")
    assert set(s["unplanned"]) == {"bsr_spmm", "linear_attention", "decode_attention",
                                   "decode_attention#decode"}
    assert not [f for f in findings if f.rule == "smem-budget"]


def test_check_candidates_flags_a_budget_below_the_pick_and_no_feasible_plan():
    from repro_torch.hopper import gemm

    cands = gemm.candidates(256, 256, 256, 132, True)
    pick = dispatch.model_pick(cands)
    limits = plan_rules.card_limits("cpu")
    assert plan_rules.check_candidates(cands, limits, name="gemm") == []
    tight = plan_rules.CardLimits(132, pick.smem - 1, pick.threads - 1, pick.threads * pick.regs - 1)
    problems = plan_rules.check_candidates(cands, tight, name="gemm")
    assert len(problems) == 3 and all(p.startswith("gemm: the model's pick") for p in problems)
    assert "shared memory" in problems[0] and "threads" in problems[1]
    assert "registers" in problems[2]
    none_fit = gemm.candidates(256, 256, 256, 132, True, smem_budget=0)
    assert plan_rules.check_candidates(none_fit, limits, name="gemm") == [
        "gemm: no feasible plan among 512 candidates (pruned by registers, shared memory, "
        "threads)"]
    assert plan_rules.check_candidates([], limits, name="x") == [
        "x: the planner lists no candidates"]


def test_smem_budget_rule_names_the_case_past_a_seeded_budget(monkeypatch):
    monkeypatch.setattr(plan_rules, "card_limits",
                        lambda device: plan_rules.CardLimits(132, 40000, source="seeded"))
    findings = run_rules(["smem-budget"])
    names = {f.path.rsplit(":", 1)[1] for f in findings}
    # the gemm and scaled-gemm picks need more than 40000 bytes: at that
    # budget their planners keep only plans that fit, or none
    assert names and names <= {"gemm", "gemm@bf16", "gemm@fp8"}, [f.format() for f in findings]
    assert all(f.rule == "smem-budget" and f.message.startswith(f.path.rsplit(":", 1)[1])
               for f in findings)


# ---------------------------------------------------------------------------
# The kernels' KernelStreams, held to the plain forms' tensors
# ---------------------------------------------------------------------------


def _rand(*shape, dtype=torch.float32, gen=None):
    return torch.randn(shape, generator=gen).to(dtype)


def _record(monkeypatch, owner, attr):
    """Wrap ``owner.attr`` to record its positional tensors and output."""
    seen = {}
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        seen["out"] = fn(*args, **kwargs)
        return seen["out"]

    monkeypatch.setattr(owner, attr, wrapped)
    return seen


def _structs(xs):
    return tuple(None if x is None else (tuple(x.shape), x.dtype) for x in xs)


def _hold(streams, ins, outs, scales=(), block=0):
    """The declaration's values/indices equal ``ins``, its scales
    ``scales`` (each of extent ``block``), its outputs ``outs``."""
    ins = [x for x in ins if x is not None]
    plain = [o for o in streams.operands if o.role != "scale"]
    assert [(o.shape, o.dtype) for o in plain] == list(_structs(ins)), streams.name
    roles = ["index" if x.dtype in (torch.int32, torch.int64) else "value" for x in ins]
    assert [o.role for o in plain] == roles, streams.name
    declared = [o for o in streams.operands if o.role == "scale"]
    assert [(o.shape, o.dtype) for o in declared] == list(_structs(scales)), streams.name
    assert all(o.block == block for o in declared), streams.name
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    assert [(o.shape, o.dtype) for o in streams.outs] == list(_structs(outs)), streams.name


def _torch_impl(monkeypatch, op):
    seen = {}
    fn = dispatch._REGISTRY[op]["torch"]

    def wrapped(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        seen["out"] = fn(*args, **kwargs)
        return seen["out"]

    monkeypatch.setitem(dispatch._REGISTRY[op], "torch", wrapped)
    return seen


DENSE_CASES = ["gemm-fp32", "gemm-bf16", "flash-fp32", "flash-bf16-lse"]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_declarations_equal_the_torch_impls_tensors(monkeypatch, case):
    gen = torch.Generator().manual_seed(0)
    if case.startswith("gemm"):
        dtype = torch.float32 if case.endswith("fp32") else torch.bfloat16
        seen = _torch_impl(monkeypatch, "gemm")
        a, b = _rand(48, 40, dtype=dtype, gen=gen), _rand(40, 24, dtype=dtype, gen=gen)
        ops.gemm(a, b, impl="torch")
        streams = dispatch.kernel_streams("gemm", _structs((a, b)))
        want = "gemm/ffma" if dtype == torch.float32 else "gemm/mma"
    else:
        dtype = torch.float32 if case.endswith("fp32") else torch.bfloat16
        lse = case.endswith("lse")
        seen = _torch_impl(monkeypatch, "flash_attention")
        q = _rand(1, 4, 24, 32, dtype=dtype, gen=gen)
        k, v = (_rand(1, 2, 40, 32, dtype=dtype, gen=gen) for _ in range(2))
        ops.flash_attention(q, k, v, impl="torch", return_lse=lse)
        streams = dispatch.kernel_streams("flash_attention", _structs((q, k, v)),
                                          return_lse=lse)
        want = "flash_attention/ffma" if dtype == torch.float32 else "flash_attention/mma"
    assert streams.name == want and streams.accum == torch.float32
    _hold(streams, seen["args"], seen["out"])


def test_narrow_accumulator_declaration_equals_the_per_block_plain_version(monkeypatch):
    from repro_torch.hopper import gemm

    seen = _record(monkeypatch, blocked, "gemm_accum_blocked")
    gen = torch.Generator().manual_seed(1)
    a, b = _rand(40, 96, dtype=torch.bfloat16, gen=gen), _rand(96, 24, dtype=torch.bfloat16, gen=gen)
    out = gemm.gemm_cuda(a, b, accum_dtype=torch.bfloat16, bk=32)  # CPU: the plain version
    streams = dispatch.kernel_streams("gemm", _structs((a, b)), accum_dtype=torch.bfloat16)
    assert streams.name == "gemm/mma+bfloat16-accum" and streams.accum == torch.bfloat16
    assert seen["kwargs"]["accum_dtype"] == streams.accum
    _hold(streams, seen["args"], out)


@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp8", "fp8_e5m2"])
def test_scaled_gemm_declaration_equals_the_quantized_operands(monkeypatch, policy):
    seen = _record(monkeypatch, blocked, "gemm_scaled_values_blocked")
    gen = torch.Generator().manual_seed(2)
    a, b = _rand(64, 300, gen=gen), _rand(300, 80, gen=gen)
    p = prec.resolve(policy)
    ops.gemm(a, b, precision=p, impl="torch")
    streams = dispatch.kernel_streams("gemm", _structs((a, b)), p)
    assert streams.name.startswith("gemm_scaled/") and streams.name.endswith(f"@{policy}")
    aq, bq, a_scale, b_scale = seen["args"]
    _hold(streams, (aq, bq), seen["out"], (a_scale, b_scale), block=seen["kwargs"]["bk"])


@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp8", "fp8_e5m2"])
def test_scaled_flash_declaration_equals_the_quantized_operands(monkeypatch, policy):
    seen = _record(monkeypatch, blocked, "flash_attention_scaled_values_blocked")
    gen = torch.Generator().manual_seed(3)
    q = _rand(1, 4, 24, 32, gen=gen)
    k, v = (_rand(1, 2, 40, 32, gen=gen) for _ in range(2))
    p = prec.resolve(policy)
    out = ops.flash_attention(q, k, v, precision=p, impl="torch", return_lse=True)
    streams = dispatch.kernel_streams("flash_attention", _structs((q, k, v)), p,
                                      return_lse=True)
    qq, kq, vq, qs, ks, vs = seen["args"]
    _hold(streams, (qq, kq, vq), out, (qs, ks, vs), block=32)


DECODE_CASES = ["contiguous-fp32", "contiguous-bf16-lse", "paged-bf16", "paged-fp8-lse",
                "contiguous-precision-fp8"]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_declarations_equal_the_plain_forms_tensors(monkeypatch, case):
    gen = torch.Generator().manual_seed(5)
    dtype = torch.float32 if case.endswith("fp32") or "fp8" in case else torch.bfloat16
    lse = case.endswith("lse")
    B, H, K, D, bs, nb = 2, 4, 2, 64, 8, 3
    q = _rand(B, H, D, dtype=dtype, gen=gen)
    pos = torch.tensor([5, 20], dtype=torch.int32)
    kw, scales, policy = {"return_lse": lse}, (), None
    if case.startswith("paged"):
        k, v = (_rand(B * nb + 1, K, bs, D, dtype=dtype, gen=gen) for _ in range(2))
        kw["block_table"] = torch.arange(1, B * nb + 1, dtype=torch.int32).reshape(B, nb)
        if "fp8" in case:
            k, ks, v, vs = prec.quantize_kv_cache(k, v, "fp8")
            kw.update(k_scale=ks, v_scale=vs)
            scales = (ks, vs)
        seen = _torch_impl(monkeypatch, "decode_attention")
        out = ops.decode_attention(q, k, v, pos, paged=True, impl="torch", **kw)
        ins = (*seen["args"], kw["block_table"])
    else:
        k, v = (_rand(B, K, nb * bs, D, dtype=dtype, gen=gen) for _ in range(2))
        if "precision" in case:
            policy = prec.resolve("fp8")
            seen = _record(monkeypatch, prec, "quantize_kv_cache")
            out = ops.decode_attention(q, k, v, pos, precision=policy, impl="torch", **kw)
            kq, ks, vq, vs = seen["out"]
            ins, scales = (q, kq, vq, pos), (ks, vs)
        else:
            seen = _torch_impl(monkeypatch, "decode_attention")
            out = ops.decode_attention(q, k, v, pos, impl="torch", **kw)
            ins = seen["args"]
    streams = dispatch.kernel_streams("decode_attention", _structs(ins[:4]), policy, **kw)
    assert streams.name == "flash_decode/" + case.split("-")[0]
    assert streams.accum == torch.float32
    _hold(streams, ins, out, scales, block=D if scales else 0)
    assert not plan_rules.check_accum_widening(streams)
    assert not check_dtype_dataflow(streams, policy)


SPARSE_CASES = ["spmm", "bsr_spmm", "spmspm", "stencil", "linear_attention", "ring_hop"]


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_scan_and_hop_declarations_equal_the_torch_impls_tensors(monkeypatch, case):
    gen = torch.Generator().manual_seed(4)
    kw = {}
    if case == "ring_hop":
        src, dst = _rand(3, 17, dtype=torch.bfloat16, gen=gen), torch.empty(3, 17, dtype=torch.bfloat16)
        ring_hop.ring_hop_plain(src, dst)
        streams = dispatch.kernel_streams("ring_hop", _structs((src,)))
        assert streams.accum is None
        _hold(streams, (src,), dst)
        return
    seen = _torch_impl(monkeypatch, case)
    if case == "spmm":
        values = _rand(30, 5, dtype=torch.bfloat16, gen=gen)
        cols = torch.randint(0, 20, (30, 5), generator=gen, dtype=torch.int32)
        ops.spmm(values, cols, _rand(20, 12, dtype=torch.bfloat16, gen=gen), impl="torch")
    elif case == "bsr_spmm":
        tv = _rand(3, 8, 16, gen=gen)
        rows, cols = torch.tensor([0, 0, 2], dtype=torch.int32), torch.tensor([0, 1, 1], dtype=torch.int32)
        ops.bsr_spmm(tv, rows, cols, _rand(32, 12, gen=gen), 24, impl="torch")
        kw = {"num_rows": 24}
    elif case == "spmspm":
        av, bv = _rand(10, 4, gen=gen), _rand(14, 3, gen=gen)
        ac = torch.randint(0, 50, (10, 4), generator=gen, dtype=torch.int32)
        bc = torch.randint(0, 50, (14, 3), generator=gen, dtype=torch.int32)
        ops.spmspm(av, ac, bv, bc, 50, impl="torch")
    elif case == "stencil":
        import numpy as np

        offs = np.array([(0, 0, 0), (1, 0, 0), (-1, 0, 0)], np.int32)
        ops.stencil(_rand(8, 6, 5, dtype=torch.bfloat16, gen=gen), offs,
                    np.full(3, 1 / 3, np.float32), impl="torch")
    else:
        r, k = (_rand(1, 2, 20, 8, dtype=torch.bfloat16, gen=gen) for _ in range(2))
        v = _rand(1, 2, 20, 6, dtype=torch.bfloat16, gen=gen)
        w = -torch.rand((1, 2, 20, 8), generator=gen)
        ops.linear_attention(r, k, v, w, _rand(2, 8, gen=gen), _rand(1, 2, 8, 6, gen=gen),
                             impl="torch", chunk=8)
    args = seen["args"]
    streams = dispatch.kernel_streams(case, _structs(args), **kw)
    assert streams.accum == torch.float32
    _hold(streams, args, seen["out"])


def test_every_kernel_declares_its_streams():
    declared = [k for decls in dispatch._STREAMS.values() for k, _ in decls]
    assert sorted(declared) == sorted(build.SOURCES)
    with pytest.raises(LookupError):
        dispatch.kernel_streams("decode_attention", (((2, 4, 8), torch.float32),))
    with pytest.raises(LookupError):  # the scaled kernel sums in fp32 only
        dispatch.kernel_streams("gemm", (((8, 8), torch.float32), ((8, 8), torch.float32)),
                                prec.resolve("fp8"), accum_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# Widening and dataflow over the declarations
# ---------------------------------------------------------------------------


def test_widening_and_dataflow_flag_the_real_narrow_accumulator_declaration():
    bf = torch.bfloat16
    narrow = dispatch.kernel_streams("gemm", (((64, 64), bf), ((64, 32), bf)), accum_dtype=bf)
    [w] = plan_rules.check_accum_widening(narrow)
    assert "no fp32+ accumulator" in w and "sums in bfloat16" in w
    [d] = check_dtype_dataflow(narrow)
    assert "fold into a 2-byte accumulator" in d and "accumulation" in d
    wide = dispatch.kernel_streams("gemm", (((64, 64), bf), ((64, 32), bf)))
    assert plan_rules.check_accum_widening(wide) == check_dtype_dataflow(wide) == []
    hop = dispatch.kernel_streams("ring_hop", (((4, 4), bf),))
    assert plan_rules.check_accum_widening(hop) == check_dtype_dataflow(hop) == []


def test_dataflow_flags_fp8_values_without_a_scale():
    f8 = torch.float8_e4m3fn
    bare = KernelStreams("bare_fp8", (StreamOperand("value", (8, 8), f8),), torch.float32,
                         (StreamOperand("value", (8, 8), torch.float32),))
    [p] = check_dtype_dataflow(bare)
    assert "no fp32 scale stream" in p
    [p, q] = check_dtype_dataflow(bare, prec.resolve("fp8"))
    assert "takes no scales" in q
    scaled = dispatch.kernel_streams("gemm", (((64, 256), torch.float32), ((256, 64), torch.float32)),
                                     prec.resolve("fp8"))
    assert check_dtype_dataflow(scaled, prec.resolve("fp8")) == []
    index_only = KernelStreams("ix", (StreamOperand("index", (8,), torch.int32),), torch.float32,
                               (StreamOperand("value", (8,), torch.float32),))
    assert plan_rules.check_accum_widening(index_only) == check_dtype_dataflow(index_only) == []


def test_rules_flag_a_seeded_declaration_and_a_missing_one(monkeypatch):
    bf = torch.bfloat16

    def narrow_stencil(structs, policy=None, **_):
        (shape, _), = structs[:1]
        return KernelStreams("stencil/seeded", (StreamOperand("value", shape, bf),), bf,
                             (StreamOperand("value", shape, bf),))

    monkeypatch.setitem(dispatch._STREAMS, "stencil", [("stencil", narrow_stencil)])
    monkeypatch.setitem(dispatch._STREAMS, "spmm", [])
    findings = run_rules(["accum-dtype-widening", "dtype-dataflow"])
    got = sorted((f.rule, f.path.rsplit(":", 1)[1], f.message) for f in findings)
    assert [g[:2] for g in got] == [
        ("accum-dtype-widening", "spmm"), ("accum-dtype-widening", "stencil"),
        ("dtype-dataflow", "spmm"), ("dtype-dataflow", "stencil")], got
    assert "declare no KernelStreams" in got[0][2] and "declare no KernelStreams" in got[2][2]
    assert "stencil/seeded: streams sub-fp32" in got[1][2]
    assert "stencil/seeded: 1 sub-fp32 value stream(s) fold into a 2-byte" in got[3][2], [f.format() for f in findings]


def test_sweeps_read_every_kernel_case_and_name_the_kernelless(full_run):
    _, stats = full_run
    for rule in ("accum-dtype-widening", "dtype-dataflow"):
        s = stats[rule]
        assert s["kernelless"] == {}  # decode attention has its kernel now
        for case in ("decode_attention", "decode_attention#decode"):
            assert s[case]["kernel"] == "flash_decode/contiguous" and s[case]["accum"] == "float32"
        assert s["gemm@fp8"]["kernel"] == "gemm_scaled/wgmma@fp8"
        assert s["gemm@fp8"]["operands"] == ["value:float8_e4m3fn"] * 2 + ["scale:float32"] * 2
        assert len(s) == 14


# ---------------------------------------------------------------------------
# The real tree is clean, and the CLI speaks both formats
# ---------------------------------------------------------------------------


def test_real_tree_is_clean(full_run):
    findings, stats = full_run
    assert findings == [], "\n".join(f.format() for f in findings)
    assert set(stats) == {"smem-budget", "accum-dtype-widening", "dtype-dataflow",
                          "scheduler-model", "overlap-interleavings"}


def test_cli_json_format(capsys):
    code = cli.main(["--rules", "single-launch-site,smem-budget", "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert code == 0 and report["count"] == 0 and report["findings"] == []
    assert report["rules"] == ["single-launch-site", "smem-budget"]
    assert report["device"] == "cpu"
    assert report["stats"]["smem-budget"]["limits"]["source"].startswith("H100 constants")


def test_cli_findings_exit_code(capsys):
    code = cli.main(["--rules", "block-geometry-registry-only", "--root",
                     str(FIXTURES / "block_geometry"), "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert code == 1 and report["count"] == 5
    assert all(f["rule"] == "block-geometry-registry-only" for f in report["findings"])


def test_cli_unknown_rule_exit_code(capsys):
    assert cli.main(["--rules", "nope"]) == 2
    assert "unknown rules" in capsys.readouterr().err


def test_cli_list_by_tier(capsys):
    assert cli.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 15
    tiers = [ln.split("[")[1].split("]")[0].strip() for ln in lines]
    assert tiers == sorted(tiers, key=base.TIER_ORDER.index)
    for r in registered_rules():
        assert any(ln.startswith(r.name) for ln in lines)


@pytest.mark.cuda
def test_card_tier_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card tier reads the card's limits and shapes")
    stats = {}
    findings = run_rules(["smem-budget", "accum-dtype-widening", "dtype-dataflow"],
                         stats=stats, device="cuda")
    assert findings == [], [f.format() for f in findings]
    limits = stats["smem-budget"]["limits"]
    props = torch.cuda.get_device_properties(0)
    assert limits["sms"] == props.multi_processor_count
    assert limits["smem_per_block"] == props.shared_memory_per_block_optin
