"""The port's dry run (``launch/step_count.py`` under
``launch/shape_run.count_cell``, ``launch/shape_report.py``,
``launch/shape_climb.py``, ``launch/op_doc.py``) against the JAX
reference on the CPU.

- (i) Per device against XLA: one subprocess with 8 forced host devices
  and a 2 x 4 ``("data", "model")`` mesh with ``AxisType.Auto`` axes (as
  ``tests/test_torch_sharding.py`` builds it: jax 0.9.0's default explicit
  axes are what fail the reference's own multi-device tests) runs the
  reference's ``dryrun._cost_point`` on REDUCED occamy-gptj, rwkv6-3b and
  phi3.5-moe at 2 layers, each shape at S = 256, B = 8; the port counts
  the same cells. FLOPs per device within ``XLA_FLOPS_REL`` (10 %) of
  ``cost_analysis()``'s in each of the nine; collective bytes non-zero
  exactly where XLA's are; HBM and collective bytes printed beside XLA's
  (the port's eager program fuses nothing, XLA's does).
- (ii) ``argument_size_in_bytes`` for every config x applicable shape on
  both production meshes equals the sum of the reference's shard shapes
  (``NamedSharding(AbstractMesh(...), spec).shard_shape`` over the
  reference's ``jax.eval_shape`` trees and specs; no compile).
- (iii) The full-size CLI (``shape_run.main``) on three cells of three
  families, one train, one prefill, one decode: no error, FLOPs per device
  x devices >= ``model_flops``, ``useful_flops_ratio`` in (0, 1], and the
  ``shape_applicable`` skips the reference's.
- (iv) ``shape_report``'s tables, ``shape_climb``'s overrides, and
  ``op_doc``'s plan cells op by op equal to the reference's
  ``docgen.generate()`` on the same cases; ``op_doc --check`` on the
  committed ``docs/op-reference-torch.md``.
- The counter's own rules on small tensors (a sequence-split activation
  meeting a head-split weight, a contraction over a split dim settled by a
  constraint, a reshape round trip), and its aten-matmul FLOPs against
  ``torch.utils.flop_counter.FlopCounterMode`` over the real step on the
  CPU, exactly.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import shape_applicable as jax_shape_applicable  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec, all_arch_ids, get_config  # noqa: E402
from repro_torch.configs.base import shape_applicable  # noqa: E402
from repro_torch.hopper.partition import MeshSpec  # noqa: E402
from repro_torch.launch import op_doc, shape_climb, shape_report, shape_run, step_count  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
XLA_FLOPS_REL = 0.10
ARCHS = sorted(all_arch_ids())
PROD = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# (i): the REDUCED configs at 2 layers, every shape at S = 256, B = 8
XLA_ARCHS = ("occamy-gptj", "rwkv6-3b", "phi3.5-moe-42b-a6.6b")
XLA_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
XLA_CELLS = [(a, s) for a in XLA_ARCHS for s in XLA_SHAPES]
XLA_MESH = {"data": 2, "model": 4}


def _small(shape_name):
    return dataclasses.replace(SHAPES[shape_name], seq_len=256, global_batch=8)


# ---------------------------------------------------------------------------
# (i) per device against XLA's cost analysis
# ---------------------------------------------------------------------------

_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from jax.sharding import AxisType
    from repro.configs.base import SHAPES, get_config
    from repro.launch import dryrun

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in %(archs)r:
        cfg = get_config(arch, reduced=True)
        for name in %(shapes)r:
            shape = dataclasses.replace(SHAPES[name], seq_len=256, global_batch=8)
            c = dryrun._cost_point(cfg, shape, mesh, 2)
            out[arch + "/" + name] = {k: c[k] for k in ("flops", "hbm_bytes", "coll_bytes",
                                                         "coll_by_kind")}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""") % {"archs": XLA_ARCHS, "shapes": XLA_SHAPES}


@pytest.fixture(scope="module")
def xla_costs(tmp_path_factory):
    path = tmp_path_factory.mktemp("xla") / "costs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path)], capture_output=True,
                          text=True, timeout=REF_TIMEOUT, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


@functools.lru_cache(maxsize=None)
def _port_cost(arch, shape_name):
    return step_count.count_step(get_config(arch, reduced=True), _small(shape_name),
                                 MeshSpec(XLA_MESH))


@pytest.mark.parametrize("arch,shape_name", XLA_CELLS)
def test_flops_per_device_within_ten_percent_of_xla(xla_costs, arch, shape_name):
    want = xla_costs[f"{arch}/{shape_name}"]
    got = _port_cost(arch, shape_name)
    rel = got["flops"] / want["flops"] - 1
    print(f"{arch} {shape_name}: flops {got['flops']:.4g} / XLA {want['flops']:.4g} "
          f"({rel:+.3f}); hbm {got['hbm_bytes']:.4g} / {want['hbm_bytes']:.4g} "
          f"({got['hbm_bytes'] / want['hbm_bytes']:.2f}x); coll {got['coll_bytes']:.4g} / "
          f"{want['coll_bytes']:.4g}; by kind {got['coll_by_kind']} / {want['coll_by_kind']}")
    assert abs(rel) <= XLA_FLOPS_REL
    assert (got["coll_bytes"] > 0) == (want["coll_bytes"] > 0)


# ---------------------------------------------------------------------------
# (ii) argument bytes at full width against the reference's shard shapes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = jax_get_config(arch)
    return cfg, jregistry.param_shapes(cfg), jtrain_loop.train_state_struct(cfg)


def _ref_argument_bytes(arch, shape_name, mesh_shape):
    cfg, params, state = _ref_trees(arch)
    shape = JSHAPES[shape_name]
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    mode = "train" if shape.kind == "train" else "serve"
    pspecs = jsh.param_specs(cfg, params, mesh, mode)
    batch = jregistry.input_specs(cfg, shape)
    pairs = [(batch, jsh.batch_specs(cfg, batch, mesh))]
    if shape.kind == "train":
        pairs.append((state, {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                                         "step": jax.sharding.PartitionSpec()}}))
    else:
        pairs.append((params, pspecs))
        if shape.kind == "decode":
            cache = jregistry.cache_spec(cfg, shape.global_batch, shape.seq_len)
            pairs.append((cache, jsh.cache_specs(cfg, cache, mesh)))
    total = 0
    for tree, specs in pairs:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            local = JNamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += math.prod(local) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh_name", sorted(PROD))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_shard_shapes(arch, mesh_name):
    mesh = MeshSpec(PROD[mesh_name])
    cfg = get_config(arch)
    for shape_name in SHAPES:
        if not shape_applicable(cfg, SHAPES[shape_name])[0]:
            continue
        got = step_count.step_arguments(cfg, SHAPES[shape_name], mesh)["argument_bytes"]
        assert got == _ref_argument_bytes(arch, shape_name, PROD[mesh_name]), shape_name


# ---------------------------------------------------------------------------
# (iii) the full-size CLI
# ---------------------------------------------------------------------------

CLI_CELLS = (("gemma-2b", "train_4k"), ("rwkv6-3b", "prefill_32k"),
             ("phi3.5-moe-42b-a6.6b", "decode_32k"))


@pytest.fixture(scope="module")
def cli_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells") / "cells.jsonl"
    for arch, shape_name in CLI_CELLS:
        assert shape_run.main(["--arch", arch, "--shape", shape_name, "--out", str(out)]) == 0
    assert shape_run.main(["--arch", "gemma-2b", "--shape", "long_500k", "--out", str(out)]) == 0
    return out


@pytest.mark.parametrize("arch,shape_name", CLI_CELLS)
def test_full_size_cli_cell(cli_cells, arch, shape_name):
    rows = shape_report.load([cli_cells])
    r = rows[(arch, shape_name, "16x16")]
    assert "error" not in r and r["devices"] == 256
    assert r["flops_per_device"] * r["devices"] >= r["model_flops_global"]
    assert 0 < r["useful_flops_ratio"] <= 1
    mem = r["memory"]
    assert mem["total_per_device"] == (mem["argument_size_in_bytes"]
                                       + mem["output_size_in_bytes"]
                                       + mem["temp_size_in_bytes"]
                                       - mem["alias_size_in_bytes"])
    assert r["fits"] == (mem["total_per_device"] <= 80e9)
    assert set(r["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant",
                                  "roofline_fraction", "memory_floor_s", "memory_efficiency"}
    assert set(r["coll_counts_per_layer"]) == set(step_count.COLL_KINDS)
    assert mem["argument_size_in_bytes"] == step_count.step_arguments(
        get_config(arch), SHAPES[shape_name], MeshSpec(PROD["16x16"]))["argument_bytes"]


def test_cli_skips_what_the_reference_skips(cli_cells):
    r = shape_report.load([cli_cells])[("gemma-2b", "long_500k", "16x16")]
    ok, reason = jax_shape_applicable(jax_get_config("gemma-2b"), JSHAPES["long_500k"])
    assert not ok and r == {"arch": "gemma-2b", "shape": "long_500k", "skipped": reason,
                            "mesh": "16x16"}
    for arch in ARCHS:
        for shape_name in SHAPES:
            want = jax_shape_applicable(jax_get_config(arch), JSHAPES[shape_name])
            assert shape_applicable(get_config(arch), SHAPES[shape_name]) == want


def test_cli_error_cell_exits_one(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(shape_run, "count_cell", broken)
    out = tmp_path / "e.jsonl"
    assert shape_run.main(["--arch", "gemma-2b", "--shape", "train_4k", "--out", str(out)]) == 1
    assert json.loads(out.read_text())["error"] == "RuntimeError: boom"


# ---------------------------------------------------------------------------
# (iv) the report, the climb and the op reference
# ---------------------------------------------------------------------------


def test_report_tables(cli_cells):
    rows = shape_report.load([cli_cells])
    dry = shape_report.dryrun_table(rows).splitlines()
    assert dry[0].startswith("| arch | shape | mesh | count |") and "| fits |" in dry[0]
    assert len(dry) == 2 + len(CLI_CELLS) + 1
    assert any("skipped: long_500k" in ln for ln in dry)
    roof = shape_report.roofline_table(rows).splitlines()
    assert len(roof) == 2 + len(CLI_CELLS)
    assert roof[2].startswith("| gemma-2b | train_4k |")


def test_climb_parse_override():
    assert shape_climb.parse_override("microbatches=2") == ("microbatches", 2)
    assert shape_climb.parse_override("capacity_factor=1.5") == ("capacity_factor", 1.5)
    assert shape_climb.parse_override("tp_reduce_bf16=True") == ("tp_reduce_bf16", True)
    assert shape_climb.parse_override("remat=dots") == ("remat", "dots")


def test_climb_tp_reduce_bf16_lowers_the_moe_cells_bytes():
    """The fp32 expert hidden buffers become bf16: less HBM traffic, the
    same FLOPs; the expert output is bf16 either way in the port, so the
    collective bytes do not move."""
    r = shape_climb.climb("phi3.5-moe-42b-a6.6b", "prefill_32k", {"tp_reduce_bf16": True})
    d = r["deltas"]
    assert r["overrides"] == {"tp_reduce_bf16": True}
    assert d["hbm_bytes_per_device"] < 0 and d["memory_s"] < 0
    assert d["flops_per_device"] == 0 and d["coll_bytes_per_device"] == 0


def test_climb_fsdp_off_trades_gathers_for_memory():
    """Without FSDP a train cell holds its whole (TP-split) state on every
    data rank and gathers no weights: more argument bytes, fewer collective
    bytes."""
    base = shape_run.count_cell("gemma-2b", "train_4k", False)
    r = shape_climb.climb("gemma-2b", "train_4k", {"fsdp": False})
    assert r["memory"]["argument_size_in_bytes"] > base["memory"]["argument_size_in_bytes"]
    assert r["deltas"]["coll_bytes_per_device"] < 0
    assert "memory" not in shape_climb.climb("gemma-2b", "decode_32k", {}, skip_full=True)


def _ref_plan_rows(text, title):
    part = text.split(title, 1)[1].split("\n## ", 1)[0]
    return [tuple(c.strip() for c in ln.strip().strip("|").split("|"))
            for ln in part.splitlines() if ln.startswith("| `")]


def test_op_doc_plans_equal_the_reference_docgen():
    from repro.launch import docgen

    text = docgen.generate()
    for multi_pod, title in ((False, "Partitioning on the single-pod mesh"),
                             (True, "Partitioning on the two-pod mesh")):
        want = _ref_plan_rows(text, title)
        got = [(f"`{op}`", *rest) for op, *rest in op_doc.plan_rows(multi_pod)]
        assert [r[0] for r in got] == [r[0] for r in want]
        for g, w in zip(got, want):
            assert g == w


def test_op_doc_check_passes_on_the_committed_file_and_fails_on_drift(tmp_path):
    assert op_doc.main(["--check", "--out", str(ROOT / "docs" / "op-reference-torch.md")]) == 0
    stale = tmp_path / "op.md"
    stale.write_text(op_doc.generate().replace("spmspm", "spmspm2", 1))
    assert op_doc.main(["--check", "--out", str(stale)]) == 2
    assert op_doc.main(["--check", "--out", str(tmp_path / "missing.md")]) == 2
    text = op_doc.generate()
    assert "cuda, ref, torch" in text and "NVLink" in text and "ICI" not in text


# ---------------------------------------------------------------------------
# the counter's rules
# ---------------------------------------------------------------------------


def _seeded(counter, shape, spec, dtype=torch.float32):
    return counter.seed(torch.empty(shape, dtype=dtype, device="meta"), sh.P(*spec))


def test_sequence_split_activation_meets_a_head_split_weight():
    """x (B, S, d) split over data and (sequence) model against w (d, f)
    split over model: the smaller operand, the weight, is gathered; the
    product's split is x's, and its FLOPs divide by all 8 ranks."""
    c = step_count.StepCount({"data": 2, "model": 4})
    x = _seeded(c, (8, 16, 32), ("data", "model", None))
    w = _seeded(c, (32, 64), (None, "model"))
    with c:
        y = torch.matmul(x, w)
    assert step_count._spec(y) == (("data",), ("model",), ())
    assert c.coll_counts["all-gather"] == 1 and c.coll["all-gather"] == 32 * 64 * 4
    assert c.matmul_flops == 2 * 8 * 16 * 32 * 64 / 8


def test_split_contraction_is_settled_by_the_constraint():
    """A contraction over a split dim leaves partial sums; a residual
    constraint that splits the sequence over the same axis settles them as
    a reduce-scatter, one that does not as an all-reduce."""
    for spec, kind, nbytes in (((("data",), ("model",), ()), "reduce-scatter", 4 * 16 * 32 * 4),
                               ((("data",), (), ()), "all-reduce", 2 * 4 * 16 * 32 * 4)):
        c = step_count.StepCount({"data": 2, "model": 4})
        h = _seeded(c, (8, 16, 64), ("data", None, "model"))
        w = _seeded(c, (64, 32), ("model", None))
        named = sh.NamedSharding(MeshSpec({"data": 2, "model": 4}),
                                 sh.P(*[a[0] if a else None for a in spec]))
        with sh.activation_sharding({"residual": named, "__count__": c}), c:
            y = sh.constrain(torch.matmul(h, w), "residual")
        assert step_count._part(y) is None and step_count._spec(y) == spec
        assert c.coll[kind] == nbytes and sum(c.coll_counts.values()) == 1


def test_reshape_round_trip_keeps_each_dims_axes():
    c = step_count.StepCount({"data": 2, "model": 4})
    x = _seeded(c, (8, 16, 32), ("data", "model", None))
    with c:
        y = x.reshape(8 * 16, 32).reshape(8, 16, 32)
    assert step_count._spec(y) == (("data",), ("model",), ())


@pytest.mark.parametrize("arch,kind,B,S", [("gemma-2b", "train", 2, 384),
                                           ("occamy-gptj", "prefill", 2, 384)])
def test_matmul_flops_and_arguments_equal_the_real_steps(arch, kind, B, S):
    """On a 1 x 1 mesh the counted aten-matmul FLOPs are FlopCounterMode's
    over the real step (the FA backward's einsums by formula included),
    less the plain FA forward, which the CPU runs over every key block where
    the count prices the kernel's causal blocks apart; the argument bytes
    are the real tensors'."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import registry
    from repro_torch.runtime import train_loop

    cfg = get_config(arch, reduced=True)
    shape = ShapeSpec("cell", kind, S, B)
    c = step_count.count_step(cfg, shape, MeshSpec({"data": 1, "model": 1}))
    batch = registry.make_batch(cfg, shape, device="cpu")
    if kind == "train":
        args = (train_loop.init_train_state(cfg, seed=0, device="cpu"), batch)
        step = train_loop.make_train_step(cfg)
    else:
        args = (registry.init_params(cfg, seed=0, device="cpu"), batch)
        step = train_loop.make_prefill_step(cfg)
    real = sum(t.numel() * t.element_size() for t in step_count._tensors(args))
    assert c["memory"]["argument_size_in_bytes"] == real
    with FlopCounterMode(display=False) as fc:
        step(*args)
    calls = cfg.num_layers * (2 if kind == "train" else 1)  # forward and remat recompute
    plain_fa = 4 * B * cfg.num_heads * S * S * cfg.resolved_head_dim() * calls
    assert c["matmul_flops"] + plain_fa == fc.get_total_flops()
