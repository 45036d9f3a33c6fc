"""repro_torch.analysis's model tier: the copied explorer gives the
reference's exploration counts on every scheduler config and hop sweep,
its abstract scheduler bisimulates the port's scheduler, every seeded-bad
fixture fires with the reference's counts, the quantized-pool check gives
the reference's problem strings, and the CLI's budget, exit codes and
torch-free paths hold."""
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import explore as ref_explore  # noqa: E402
from repro.analysis import model_rules as ref_model  # noqa: E402

from repro_torch.analysis import cli, explore  # noqa: E402
from repro_torch.analysis.explore import (  # noqa: E402
    Budget,
    RequestSpec,
    SchedulerConfig,
    SchedulerModel,
    explore_hop_interleavings,
)
from repro_torch.analysis.model_rules import check_dtype_dataflow, check_quantized_pool  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    NULL_BLOCK,
    ContinuousBatchingScheduler,
    Request,
    apply_action,
    canonical_state,
)

TESTS = pathlib.Path(__file__).parent
FIXTURES = TESTS / "torch_analysis_fixtures"
REF_FIXTURES = TESTS / "analysis_fixtures"
REPO = TESTS.parent


def _load(path):
    spec = importlib.util.spec_from_file_location(f"fixture_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_null_block_constant_mirrors_the_ports_scheduler():
    import ast
    import inspect

    from repro_torch.serving import scheduler

    assert explore.NULL_BLOCK == NULL_BLOCK == ref_explore.NULL_BLOCK
    # pinned at its definition: a top-level assignment of serving/scheduler.py
    tree = ast.parse(inspect.getsource(scheduler))
    [value] = [n.value.value for n in tree.body if isinstance(n, ast.Assign)
               and [t.id for t in n.targets if isinstance(t, ast.Name)] == ["NULL_BLOCK"]]
    assert value == explore.NULL_BLOCK


# ---------------------------------------------------------------------------
# The copied explorer explores what the reference's does
# ---------------------------------------------------------------------------


def test_scheduler_configs_are_the_references():
    """The same bounded configs; their explorations are compared, tag for
    tag, in ``test_rule_stats_equal_the_references``."""
    assert [t for t, _ in explore.SCHEDULER_CONFIGS] == [t for t, _ in ref_explore.SCHEDULER_CONFIGS]
    for (tag, cfg), (_, ref_cfg) in zip(explore.SCHEDULER_CONFIGS, ref_explore.SCHEDULER_CONFIGS):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg), tag


def test_hop_sweeps_equal_the_reference_state_for_state():
    from repro.parallel.collectives import ring_schedule as ref_ring_schedule

    from repro_torch.parallel.collectives import ring_schedule

    for hops in range(1, 9):
        for overlap in (False, True):
            for remote in (False, True):
                ev = ring_schedule(hops, overlap=overlap, remote_copy=remote)
                ref_ev = ref_ring_schedule(hops, overlap=overlap, remote_copy=remote)
                assert [dataclasses.astuple(e) for e in ev] == [
                    dataclasses.astuple(e) for e in ref_ev]
                problems, stats = explore_hop_interleavings(ev, hops)
                ref_problems, ref_stats = ref_explore.explore_hop_interleavings(ref_ev, hops)
                assert problems == ref_problems == []
                assert stats.as_dict() == ref_stats.as_dict(), (hops, overlap, remote)


@pytest.fixture(scope="module")
def model_rule_stats():
    """The port's and the reference's model-tier explorations, each run
    once through its own checker: {rule: {tag: counters}}."""
    from repro.analysis import run_rules as ref_run_rules

    from repro_torch.analysis import run_rules

    rules = ["scheduler-model", "overlap-interleavings"]
    port, ref = {}, {}
    assert run_rules(rules, stats=port) == []
    assert ref_run_rules(rules, stats=ref) == []
    return port, ref


def test_rule_stats_equal_the_references(model_rule_stats):
    port, ref = model_rule_stats
    assert port == ref
    hops = port["overlap-interleavings"]
    # the 32 sweeps of hops 1..8, and the production flash ring plans'
    # 16 hops on the 16 x 16 mesh (zigzag on and off plan the same count)
    assert len(hops) == 36 and sum(s["states"] for s in hops.values()) == 588
    assert sum(s["states"] for s in port["scheduler-model"].values()) == 28871
    assert not any(s["truncated"] for r in port.values() for s in r.values())


# ---------------------------------------------------------------------------
# Bisimulation: the abstract model never drifts from the port's scheduler
# ---------------------------------------------------------------------------


def _random_config(rng):
    block_size = int(rng.integers(1, 4))
    num_blocks = int(rng.integers(4, 9))
    limit = num_blocks - 1
    specs = []
    for rid in range(int(rng.integers(1, 5))):
        for _ in range(20):  # rejection-sample until it fits the pool
            p = int(rng.integers(1, 5))
            m = int(rng.integers(1, 5))
            if -(-(p + m) // block_size) <= limit:
                specs.append(RequestSpec(rid=rid, prompt_len=p, max_new_tokens=m,
                                         priority=int(rng.integers(0, 3))))
                break
    return SchedulerConfig(num_blocks=num_blocks, block_size=block_size,
                           max_slots=int(rng.integers(1, 4)), requests=tuple(specs))


@pytest.mark.parametrize("seed", range(40))
def test_model_bisimulates_the_ports_scheduler(seed):
    rng = np.random.default_rng(seed)
    cfg = _random_config(rng)
    model = SchedulerModel(cfg)
    state = model.initial()
    sched = ContinuousBatchingScheduler(num_blocks=cfg.num_blocks, block_size=cfg.block_size,
                                        max_slots=cfg.max_slots)
    requests = {r.rid: Request(rid=r.rid, prompt=(1,) * r.prompt_len,
                               max_new_tokens=r.max_new_tokens, priority=r.priority)
                for r in cfg.requests}
    model_trace = []
    for step in range(400):
        actions = model.actions(state)
        if not actions:
            break
        action = actions[int(rng.integers(len(actions)))]
        state, problems, admits = model.apply(state, action)
        assert problems == [], (seed, action, problems)
        assert admits == apply_action(sched, action, step, requests=requests), (seed, step)
        model_trace.extend((step, rid, slot) for rid, slot in admits)
        assert model.ledger_view(state) == canonical_state(sched), (seed, step, action)
    assert tuple(model_trace) == sched.admission_trace(), seed
    assert sched.allocator.check() == []
    if not model.actions(state):
        assert sched.idle() and sched.leaked_blocks() == 0
        assert set(sched.finished) == {r.rid for r in cfg.requests}


# ---------------------------------------------------------------------------
# Seeded-bad fixtures: the reference's counts
# ---------------------------------------------------------------------------


def test_starvation_detector_fires_when_bound_tightened():
    _tag, cfg = explore.SCHEDULER_CONFIGS[0]
    problems, _ = explore.explore(SchedulerModel(dataclasses.replace(cfg, starvation_bound=0)))
    assert any("starvation" in p for p in problems), problems


def test_budget_truncates_and_reports():
    _tag, cfg = explore.SCHEDULER_CONFIGS[1]
    problems, stats = explore.explore(SchedulerModel(cfg), Budget(max_states=50, max_depth=64))
    assert stats.truncated and stats.states <= 50 and problems == []


def test_bad_preempt_fixture_gives_the_reference_findings():
    bad = _load(FIXTURES / "scheduler_model" / "bad_preempt.py")
    ref = _load(REF_FIXTURES / "scheduler_model" / "bad_preempt.py")
    problems, stats = explore.explore(bad.BadPreemptModel(bad.CONFIG))
    ref_problems, ref_stats = ref_explore.explore(ref.BadPreemptModel(ref.CONFIG))
    assert problems == ref_problems and stats.as_dict() == ref_stats.as_dict()
    assert len(problems) == 2 and any("double-free" in p for p in problems)
    assert all("[after:" in p for p in problems)
    assert explore.explore(SchedulerModel(bad.CONFIG))[0] == []


def test_bad_hop_fixture_gives_the_reference_findings():
    bad = _load(FIXTURES / "hop_schedule" / "bad_schedule.py")
    ref = _load(REF_FIXTURES / "hop_schedule" / "bad_schedule.py")
    problems, _ = explore_hop_interleavings(bad.EVENTS, bad.HOPS)
    assert problems == ref_explore.explore_hop_interleavings(ref.EVENTS, ref.HOPS)[0]
    assert len(problems) == 1 and "races" in problems[0] and "has not landed" in problems[0]


def test_bad_precision_fixture_counts():
    bad = _load(FIXTURES / "precision_flow" / "bad_streams.py")
    problems = check_dtype_dataflow(bad.make_streams())
    assert len(problems) == 2, problems
    assert any("accumulation" in p for p in problems)
    assert any("no fp32 scale stream" in p for p in problems)
    pool = check_quantized_pool(bad.make_pool())
    ref_pool = ref_model.check_quantized_pool(
        _load(REF_FIXTURES / "precision_flow" / "bad_program.py").make_pool())
    assert pool == ref_pool and len(pool) == 2
    assert all("bypass the per-row scales" in p for p in pool)


def test_quantized_pool_shape_and_dtype_problems_equal_the_reference():
    import jax.numpy as jnp

    from repro.serving.paged_cache import PagedKVCache as RefCache

    from repro_torch.serving.paged_cache import PagedKVCache

    shape = (1, 3, 2, 2, 4)
    port = PagedKVCache(
        k_pool=torch.zeros(shape, dtype=torch.uint8).view(torch.float8_e4m3fn),
        v_pool=torch.zeros(shape, dtype=torch.uint8).view(torch.float8_e4m3fn),
        block_size=2, k_scale=torch.ones((1, 3, 2, 1, 1)),
        v_scale=torch.ones(shape[:-1] + (1,), dtype=torch.bfloat16), policy="fp8")
    ref = RefCache(
        k_pool=jnp.zeros(shape, jnp.float8_e4m3fn), v_pool=jnp.zeros(shape, jnp.float8_e4m3fn),
        k_scale=jnp.ones((1, 3, 2, 1, 1), jnp.float32),
        v_scale=jnp.ones(shape[:-1] + (1,), jnp.bfloat16), block_size=2, policy="fp8")
    problems = check_quantized_pool(port)
    assert problems == ref_model.check_quantized_pool(ref)
    assert any("not per-row" in p for p in problems) and any("not float32" in p for p in problems)


def test_quantized_pools_of_every_policy_are_clean():
    from repro_torch.serving.paged_cache import init_paged_cache
    from repro_torch.analysis.model_rules import _PoolCfg

    for pol in (None, "fp32", "bf16", "fp8", "fp8_e5m2"):
        cache = init_paged_cache(_PoolCfg(), num_blocks=3, block_size=2, policy=pol, device="cpu")
        assert check_quantized_pool(cache) == [], pol


# ---------------------------------------------------------------------------
# CLI: budget flag, exit codes, stats, torch-free paths
# ---------------------------------------------------------------------------


def test_cli_reports_model_stats_in_json(capsys):
    code = cli.main(["--rules", "scheduler-model", "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert code == 0 and report["findings"] == []
    per_run = report["stats"]["scheduler-model"]
    assert set(per_run) == {t for t, _ in explore.SCHEDULER_CONFIGS}
    assert sum(s["states"] for s in per_run.values()) == 28871


def test_cli_budget_exhaustion_is_exit_3_not_a_pass(capsys):
    code = cli.main(["--rules", "scheduler-model", "--budget", "40,64", "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert code == 3
    assert {f["kind"] for f in report["findings"]} == {"budget-exhausted"}
    assert any(s["truncated"] for s in report["stats"]["scheduler-model"].values())


def test_cli_bad_budget_is_usage_error(capsys):
    assert cli.main(["--budget", "nope"]) == 2
    assert "budget must be" in capsys.readouterr().err
    assert Budget.parse("500,9").max_depth == 9
    with pytest.raises(ValueError):
        Budget.parse("0")


def test_cli_list_and_usage_errors_import_neither_torch_nor_jax(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'torch', 'repro'):\n"
        "            raise ImportError(f'{name} blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.analysis import cli\n"
        "assert cli.main(['--list']) == 0\n"
        "assert cli.main(['--rules', 'nope']) == 2\n"
        "assert cli.main(['--budget', 'junk']) == 2\n"
        "assert cli.main(['--rules', 'scheduler-model']) == 0\n"
        "import repro_torch.analysis.__main__\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'torch', 'repro')]\n"
        "print('TORCH-AND-JAX-FREE-OK')\n"
    )
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "TORCH-AND-JAX-FREE-OK" in proc.stdout


def test_python_dash_m_runs_the_checker(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--rules", "warn-category", "--root",
         str(FIXTURES / "warncat")], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.count("warn-category: degrade.py:") == 2
