"""The port's roofline at the card's constants vs the JAX reference's, on
the CPU.

- ``core.topology``: ``collective_seconds`` for every kind, axis and ring
  size, ``levels`` and ``dp_allreduce_seconds`` against the reference's
  formulas evaluated at the port's constants (the reference's module with
  its constants swapped); no TPU constant anywhere in the port, and the
  card's peaks in one home.
- ``launch.roofline``: ``roofline_terms``, ``overlapped_*`` and the plan
  pricing (``plan_collective_seconds*``, ``op_collective_seconds``) as the
  reference's own tests hold them (``tests/test_partition.py``,
  ``tests/test_precision.py``) and against its functions at the port's
  constants; ``min_bytes_per_device`` and ``model_flops`` equal for every
  config and shape.
- ``core.precision``: ``flop_multiplier`` and ``peak_flops``.
- ``launch.op_cases`` field for field the reference's table.
- ``launch.shape_run.op_roofline_cells`` on both production meshes under
  every precision setting against the reference's ``dryrun`` cells, got
  from one subprocess (importing ``repro.launch.dryrun`` forces 512 host
  devices): the fields that hold no constant equal to the reference's, and
  every field equal, seconds to rtol 1e-12, to the reference's cells with
  its constants swapped for the port's. ``make_production_mesh`` from the
  same subprocess.
- ``launch.mesh_rows``' roofline columns and ``launch.d2d_rows`` against
  ``benchmarks/bench_d2d.py``.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import all_arch_ids  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.launch import op_cases as jcases  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.hopper import ops, partition  # noqa: E402,F401  (ops registers the impls)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import op_cases, roofline, shape_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
PRECISIONS = (None, "fp32", "bf16", "fp8", "fp8_e5m2")
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "permute")
MESH8 = partition.MeshSpec({"data": 2, "model": 4})
MESH_2POD = partition.MeshSpec({"pod": 2, "data": 2, "model": 4})
# the port's constants, as the reference's module names them
PORT_CONSTANTS = {"peak": topology.PEAK_FLOPS_BF16, "hbm": topology.HBM_BW,
                  "link": topology.NVLINK_BW, "pod": topology.POD_LINK_BW,
                  "mult": {k: p.flop_multiplier for k, p in prec.POLICIES.items()}}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def ref_at_port_constants(monkeypatch):
    """The reference's topology and roofline modules with the port's
    constants in place of its own."""
    monkeypatch.setattr(jtopo, "PEAK_FLOPS_BF16", topology.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jtopo, "HBM_BW", topology.HBM_BW)
    monkeypatch.setattr(jtopo, "ICI_LINK_BW", topology.NVLINK_BW)
    monkeypatch.setattr(jtopo, "POD_LINK_BW", topology.POD_LINK_BW)
    monkeypatch.setattr(jroof, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroof, "LINK_BW", roofline.LINK_BW)
    return jtopo, jroof


# ---------------------------------------------------------------------------
# topology and the card's constants
# ---------------------------------------------------------------------------


def test_topology_constants_are_the_cards():
    assert topology.PEAK_FLOPS_BF16 == 989.4e12
    assert topology.HBM_BW == 3.35e12
    assert topology.NVLINK_BW == 450e9
    assert topology.POD_LINK_BW == 400e9 / 8
    assert roofline.PEAK_FLOPS is topology.PEAK_FLOPS_BF16
    assert (roofline.HBM_BW, roofline.LINK_BW) == (topology.HBM_BW, topology.NVLINK_BW)
    assert topology.axis_bw("pod") == topology.POD_LINK_BW
    assert topology.axis_bw("model") == topology.axis_bw("data") == topology.NVLINK_BW


@pytest.mark.parametrize("kind", KINDS)
def test_collective_seconds_is_the_reference_formula_at_the_cards_constants(
        kind, ref_at_port_constants):
    jt, _ = ref_at_port_constants
    for axis in ("model", "data", "pod"):
        for n in (1, 2, 4, 16, 256):
            for nbytes in (0, 1, 4096, 3.5e9):
                got = topology.collective_seconds(kind, nbytes, axis, n)
                assert got == jt.collective_seconds(kind, nbytes, axis, n), (axis, n, nbytes)
    with pytest.raises(ValueError):
        topology.collective_seconds("broadcast", 1, "model", 2)


def test_levels_and_dp_allreduce_against_the_reference(ref_at_port_constants):
    jt, _ = ref_at_port_constants
    for multi_pod in (False, True):
        assert [dataclasses.astuple(lv) for lv in topology.levels(multi_pod)] == [
            dataclasses.astuple(lv) for lv in jt.levels(multi_pod)]
    for axes in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"model": 4}):
        for nb in (1e6, 2.45e9):
            assert topology.dp_allreduce_seconds(nb, axes) == jt.dp_allreduce_seconds(nb, axes)


def _source_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*"))
    return files + [ROOT / "chip_smoke.py"]


def _literals(text):
    """The numeric literals of ``text`` with an exponent, as floats."""
    return {float(m) for m in re.findall(r"(?<![\w.])\d+(?:\.\d+)?e\d+", text)}


def test_no_tpu_constant_and_one_home_for_the_cards_peaks():
    """None of the reference's TPU figures (197e12 FLOP/s, 819e9 B/s HBM,
    50e9 B/s ICI, 25e9 B/s pod) is written in the port; the card's peaks
    (989.4e12, 3.35e12, 450e9, 67e12 and their roundings) are written in
    ``core/topology.py`` and ``core/precision.py`` only."""
    home = {ROOT / "src" / "repro_torch" / "core" / "topology.py",
            ROOT / "src" / "repro_torch" / "core" / "precision.py"}
    tpu = {197e12, 819e9, 50e9, 25e9}
    peaks = {989.4e12, 989e12, 3.35e12, 450e9, 67e12, 1979e12, 1978.8e12}
    for path in _source_files():
        lits = _literals(path.read_text())
        assert not lits & tpu, (path, lits & tpu)
        if path not in home:
            assert not lits & peaks, (path, lits & peaks)


# ---------------------------------------------------------------------------
# precision: the multipliers and peaks
# ---------------------------------------------------------------------------


def test_flop_multipliers_and_peaks():
    pol = prec.POLICIES
    assert pol["bf16"].flop_multiplier == 1.0
    assert pol["fp8"].flop_multiplier == pol["fp8_e5m2"].flop_multiplier == 2.0
    assert pol["fp32"].flop_multiplier == 67e12 / 989.4e12
    assert prec.peak_flops("bf16") == 989.4e12
    assert prec.peak_flops(pol["fp8"]) == 2 * 989.4e12
    assert prec.peak_flops("fp32") == pytest.approx(67e12, rel=1e-15)
    assert prec.peak_flops_of(torch.float8_e5m2) == prec.peak_flops("fp8_e5m2")
    assert prec.peak_flops_of(torch.float32) == prec.peak_flops("fp32")
    with pytest.raises(KeyError):
        prec.peak_flops_of(torch.int8)


# ---------------------------------------------------------------------------
# roofline terms and plan pricing (tests/test_partition.py, test_precision.py)
# ---------------------------------------------------------------------------


def test_gemm_two_level_plan_and_per_level_costs():
    plan = partition.plan_for("gemm", MESH_2POD, _meta((32, 64)), _meta((64, 16)))
    assert plan.levels == (("pod", 2), ("model", 4)) and plan.n == 8
    assert [(c.kind, c.axis, c.n) for c in plan.collectives] == [
        ("all_reduce", "model", 4), ("all_reduce", "pod", 2)]
    by_level = roofline.plan_collective_seconds_by_level(plan)
    assert set(by_level) == {"model", "pod"}
    nb = 32 * 16 * 4
    assert by_level["model"] == pytest.approx(
        topology.collective_seconds("all_reduce", nb, "model", 4))
    assert by_level["pod"] == pytest.approx(
        topology.collective_seconds("all_reduce", nb, "pod", 2))
    assert roofline.plan_collective_seconds(plan) == pytest.approx(
        by_level["model"] + by_level["pod"])
    # the pod ring rides the narrower link: the same payload on fewer ranks costs more
    assert by_level["pod"] > by_level["model"]
    assert roofline.plan_collective_seconds_by_level(None) == {}


def test_plan_costing_feeds_roofline_d2d_term():
    a, b = _meta((1024, 4096)), _meta((4096, 1024))
    plan = partition.plan_for("gemm", MESH8, a, b)
    d2d = roofline.plan_collective_seconds(plan)
    assert d2d > 0.0
    assert roofline.op_collective_seconds("gemm", MESH8, a, b) == d2d
    assert roofline.op_collective_seconds("gemm", MESH8, _meta((30, 61)), _meta((61, 16))) == 0.0
    terms = roofline.roofline_terms(1e6, 1e6, 0.0, d2d_s=d2d)
    assert terms["d2d_s"] == d2d and "dominant" in terms
    assert roofline.roofline_terms(1.0, 1.0, 0.0, d2d_s=1e9)["dominant"] == "d2d_s"
    assert "d2d_s" not in roofline.roofline_terms(1.0, 1.0, 0.0)


def test_roofline_terms_peak_flops_override():
    base = roofline.roofline_terms(1e12, 0.0, 0.0)
    fp8 = roofline.roofline_terms(1e12, 0.0, 0.0, peak_flops=prec.peak_flops("fp8"))
    assert fp8["compute_s"] == pytest.approx(
        base["compute_s"] * roofline.PEAK_FLOPS / prec.peak_flops("fp8"))
    ov = roofline.overlapped_terms(1e12, 0.0, 0.0, d2d_s=0.0, hops=4,
                                   peak_flops=prec.peak_flops("fp8"))
    assert ov["compute_s"] == fp8["compute_s"]
    f32 = roofline.roofline_terms(67e9, 0.0, 0.0, peak_flops=prec.peak_flops("fp32"))
    assert f32["compute_s"] == pytest.approx(1e-3, rel=1e-12)


def test_overlapped_seconds_bounds():
    for comp, d2d, hops in ((4.0, 1.0, 4), (1.0, 4.0, 4), (2.0, 2.0, 2), (3.0, 0.0, 5),
                            (3.0, 1.0, 1)):
        ov = roofline.overlapped_seconds(comp, d2d, hops)
        assert ov <= comp + d2d
        if hops > 1 and d2d > 0:
            assert ov < comp + d2d
        else:
            assert ov == comp + d2d
    assert roofline.overlapped_seconds(4.0, 1.0, 4) == 4.0  # compute-bound: no D2D paid


def test_roofline_functions_are_the_references_at_the_cards_constants(ref_at_port_constants):
    _, jr = ref_at_port_constants
    rng = np.random.default_rng(0)
    for _ in range(50):
        flops, nbytes, coll, d2d = (float(x) for x in 10.0 ** rng.uniform(3, 15, 4))
        hops = int(rng.integers(1, 17))
        for peak in (None, prec.peak_flops("fp8"), prec.peak_flops("fp32")):
            assert roofline.roofline_terms(flops, nbytes, coll, d2d, peak) == \
                jr.roofline_terms(flops, nbytes, coll, d2d, peak)
            assert roofline.overlapped_terms(flops, nbytes, coll, d2d, hops, peak) == \
                jr.overlapped_terms(flops, nbytes, coll, d2d, hops, peak)
        assert roofline.overlapped_seconds(flops, d2d, hops) == \
            jr.overlapped_seconds(flops, d2d, hops)


@pytest.mark.parametrize("arch", sorted(all_arch_ids()))
def test_min_bytes_and_model_flops_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        for n_dev in (1, 256, 512):
            assert roofline.min_bytes_per_device(cfg, shape, n_dev) == \
                jroof.min_bytes_per_device(jcfg, jshape, n_dev), (name, n_dev)
        assert roofline.min_bytes_per_device(cfg, shape, 256, tp=8) == \
            jroof.min_bytes_per_device(jcfg, jshape, 256, tp=8)
        assert roofline.model_flops(cfg, shape) == jroof.model_flops(jcfg, jshape), name


# ---------------------------------------------------------------------------
# op cases and the cells
# ---------------------------------------------------------------------------

_DT = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.int32): torch.int32}


def test_op_cases_match_the_reference_field_for_field():
    got, want = op_cases.op_roofline_cases(), jcases.op_roofline_cases()
    assert [c[0] for c in got] == [c[0] for c in want]
    assert {c[0] for c in got} == set(partition.partitioned_ops())
    for (op, args, kw, flops, nbytes), (_, jargs, jkw, jflops, jbytes) in zip(got, want):
        assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs], op
        assert [a.dtype for a in args] == [_DT[jnp.dtype(a.dtype)] for a in jargs], op
        assert all(a.device.type == "meta" for a in args), op
        assert sorted(kw) == sorted(jkw), op
        for k in kw:
            np.testing.assert_array_equal(np.asarray(kw[k]), np.asarray(jkw[k]))
            assert np.asarray(kw[k]).dtype == np.asarray(jkw[k]).dtype
        assert (flops, nbytes) == (jflops, jbytes), op


_REF_CELLS = textwrap.dedent(
    """
    import dataclasses, json, sys
    from repro.launch import dryrun  # forces 512 host devices
    from repro.launch import roofline
    from repro.launch.mesh import make_production_mesh
    from repro.core import precision as prec, topology

    out = {"meshes": {}, "cells": {}, "swapped": {}}
    settings = [(mp, p) for mp in (False, True)
                for p in (None, "fp32", "bf16", "fp8", "fp8_e5m2")]
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        out["meshes"][str(mp)] = [list(m.axis_names), [int(m.shape[a]) for a in m.axis_names]]
    for mp, p in settings:
        out["cells"][f"{mp}/{p}"] = dryrun.op_roofline_cells(multi_pod=mp, precision=p)
    c = json.loads(sys.argv[2])
    topology.PEAK_FLOPS_BF16, topology.HBM_BW = c["peak"], c["hbm"]
    topology.ICI_LINK_BW, topology.POD_LINK_BW = c["link"], c["pod"]
    roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW = c["peak"], c["hbm"], c["link"]
    prec.PEAK_FLOPS_BF16 = c["peak"]
    prec.POLICIES = {k: dataclasses.replace(v, flop_multiplier=c["mult"][k])
                     for k, v in prec.POLICIES.items()}
    for mp, p in settings:
        out["swapped"][f"{mp}/{p}"] = dryrun.op_roofline_cells(multi_pod=mp, precision=p)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("RESULT:ok")
    """
)


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_CELLS, str(path),
                           json.dumps(PORT_CONSTANTS)], capture_output=True, text=True,
                          env=env, timeout=REF_TIMEOUT)
    assert proc.returncode == 0 and "RESULT:ok" in proc.stdout, proc.stderr[-3000:]
    return json.loads(path.read_text())


def _split(cell, path=""):
    """{path: value} over nested dicts: float fields (seconds, and the
    fractions made of them) apart from the rest."""
    floats, exact = {}, {}
    for k, v in cell.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            f, e = _split(v, p)
            floats.update(f)
            exact.update(e)
        elif isinstance(v, float) and not p.endswith(("_per_device", "oi_flops_per_byte")):
            floats[p] = v
        else:
            exact[p] = v
    return floats, exact


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_op_roofline_cells_match_the_reference(ref_cells, multi_pod, precision):
    """Every field that holds no constant (op, mesh, partition and its
    levels, devices, FLOPs and bytes per device, D2D bytes, intensity,
    overlap hops, precision) equals the reference's; every field, seconds
    and fractions to rtol 1e-12, equals the reference's cells evaluated at
    the port's constants."""
    key = f"{multi_pod}/{precision}"
    got = json.loads(json.dumps(shape_run.op_roofline_cells(multi_pod, precision)))
    want, swapped = ref_cells["cells"][key], ref_cells["swapped"][key]
    assert len(got) == len(want) == len(swapped) == 8
    for g, w, s in zip(got, want, swapped):
        gf, ge = _split(g)
        _, we = _split(w)
        sf, se = _split(s)
        free = {k: v for k, v in we.items()
                if not k.endswith(("/dominant",)) and "collective_s_per_level" not in k}
        assert {k: ge[k] for k in free} == free, g["op"]
        assert ge == se, g["op"]
        assert set(gf) == set(sf), g["op"]
        for k, v in sf.items():
            assert gf[k] == pytest.approx(v, rel=1e-12, abs=0.0), (g["op"], k)


def test_op_roofline_cells_tell_the_story(ref_cells):
    """The reference's own cell checks (``tests/test_partition.py``,
    ``tests/test_precision.py``), on the port's cells."""
    cells = shape_run.op_roofline_cells(multi_pod=False)
    assert {c["op"] for c in cells} == set(partition.partitioned_ops())
    by_op = {c["op"]: c for c in cells}
    for c in cells:
        assert c["partition"] != "replicated", c["op"]
        assert c["mesh"] == "16x16"
    for op in ("gemm", "bsr_spmm", "stencil", "flash_attention"):
        assert by_op[op]["d2d_bytes"] > 0, op
    assert "ring seq-parallel" in by_op["flash_attention"]["partition"]
    assert by_op["flash_attention"]["collective_s_per_level"].get("data", 0) > 0
    multi = {c["op"]: c for c in shape_run.op_roofline_cells(multi_pod=True)}
    for op in ("gemm", "bsr_spmm", "stencil"):
        per = multi[op]["collective_s_per_level"]
        assert per.get("model", 0) > 0 and per.get("pod", 0) > 0, op
        assert multi[op]["partition_levels"] == ["pod=2", "model=16"]
        assert multi[op]["roofline"]["d2d_s"] == pytest.approx(sum(per.values()))
    assert multi["flash_attention"]["partition_levels"] == ["data=16", "model=16"]
    f32 = {c["op"]: c for c in shape_run.op_roofline_cells(precision="fp32")}
    fp8 = {c["op"]: c for c in shape_run.op_roofline_cells(precision="fp8")}
    g32, g8 = f32["gemm"], fp8["gemm"]
    assert (g8["precision"], g32["precision"]) == ("fp8", "fp32")
    assert g32["roofline"]["compute_s"] >= 2 * g8["roofline"]["compute_s"]
    assert g8["bytes_per_device"] <= 0.5 * g32["bytes_per_device"]
    assert g8["d2d_bytes"] <= 0.5 * g32["d2d_bytes"]
    assert "bfloat16 reduce" in g8["partition"]
    assert fp8["flash_attention"]["d2d_bytes"] <= 0.5 * f32["flash_attention"]["d2d_bytes"]
    assert fp8["stencil"]["precision"] == "fp32"
    assert "precision" not in cells[0]
    # the overlapped cell never costs more than the serial one
    for c in cells:
        if "overlap" in c:
            assert c["overlap"]["overlapped_s"] <= c["overlap"]["serial_s"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_the_reference(ref_cells, multi_pod):
    axes, sizes = ref_cells["meshes"][str(multi_pod)]
    spec = tmesh.production_mesh_spec(multi_pod)
    assert list(spec.axis_names) == axes and list(spec.shape.values()) == sizes
    mesh = tmesh.make_production_mesh(multi_pod, device="meta")
    assert list(mesh.axis_names) == axes and [mesh.shape[a] for a in axes] == sizes
    assert mesh.n == math.prod(sizes) and set(mesh.devices) == {torch.device("meta")}
    # every op case's plan resolves on it
    for op, args, kw, _, _ in op_cases.op_roofline_cases():
        assert partition.plan_for(op, spec, *args, **kw) is not None, op


def test_shape_run_cli(capsys):
    shape_run.main(["--op-roofline", "--multi-pod", "--precision", "fp8"])
    lines = capsys.readouterr().out.strip().splitlines()
    cells = [json.loads(x) for x in lines]
    assert [c["op"] for c in cells] == [c["op"] for c in shape_run.op_roofline_cells(True, "fp8")]
    assert {c["mesh"] for c in cells} == {"2x16x16"}
    with pytest.raises(SystemExit):  # argparse refuses a policy it does not know
        shape_run.main(["--op-roofline", "--precision", "fp4"])
    # since the dry run's cells are ported, a run without --op-roofline counts
    # cells: one that cannot be counted is an error line and exit code 1
    assert shape_run.main(["--arch", "no-such-arch", "--shape", "decode_32k"]) == 1
    assert "error" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the benchmark twins' roofline columns
# ---------------------------------------------------------------------------


def test_mesh_rows_carry_the_plans_price():
    from repro_torch.launch import mesh_rows

    mesh = mesh_rows.parse_mesh("2x1x2", device="cpu")
    rows = mesh_rows.run(mesh, reps=1).json_rows
    rng = np.random.default_rng(0)
    cases = {c[0]: c for c in mesh_rows._cases(rng, torch.device("cpu"))}
    overlap = {c[0]: c for c in mesh_rows._overlap_cases(rng, torch.device("cpu"))}
    for r in rows:
        label = r["name"].removeprefix("mesh_overlap_").removeprefix("mesh_")
        _, op, _, args, kw = (overlap if r["overlap"] else cases)[label]
        plan = partition.plan_for(op, mesh, *args, **kw)
        assert r["d2d_model_s"] == roofline.plan_collective_seconds(plan), r["name"]
        assert f"d2d_model={r['d2d_model_s'] * 1e6:.2f}us" in r["derived"]
        if r["overlap"]:
            assert r["model_overlapped_s"] == roofline.overlapped_seconds(
                max(r["sync_us"] / 1e6 - r["d2d_model_s"], 0.0), r["d2d_model_s"], r["hops"])
            assert "model_overlapped_us=" in r["derived"]
        else:
            assert r["coll_per_level_s"] == roofline.plan_collective_seconds_by_level(plan)
            assert "coll_per_level=" in r["derived"]
    assert rows[0]["coll_per_level_s"].keys() == {"model", "pod"}


def test_d2d_rows_twin_of_bench_d2d(monkeypatch):
    from benchmarks import bench_d2d

    from repro_torch.launch import d2d_rows
    from repro_torch.parallel.mesh import DeviceMesh

    seen = []
    monkeypatch.setattr(bench_d2d, "row", lambda name, t, derived, **kw: seen.append(name))
    bench_d2d.run()  # one host device: the analytic all-reduce rows
    one = d2d_rows.run(DeviceMesh({"pod": 1}, device="cpu")).json_rows
    assert [r["name"] for r in one] == seen
    for r in one:
        if r["name"].startswith("fig13a"):
            frac = (38 - int(r["name"].rsplit("_", 1)[1])) / 38
            assert r["model_bw"] == frac * topology.POD_LINK_BW
        elif r["name"].startswith("fig13b"):
            size = int(r["name"].rsplit("_", 1)[1].removesuffix("B"))
            assert r["us_per_call"] == pytest.approx(
                (d2d_rows.LINK_LATENCY + size / topology.POD_LINK_BW) * 1e6, rel=1e-12)
        else:
            gb = float(r["name"].rsplit("_", 1)[1].removesuffix("GB"))
            assert r["model_s"] == topology.collective_seconds("all_reduce", gb * 1e9, "pod", 2)
            assert "analytic-only" in r["derived"]
    four = d2d_rows.run(DeviceMesh({"pod": 4}, device="cpu"), reps=1).json_rows
    measured = [r for r in four if r["name"].startswith("fig13b_pod_allreduce")]
    assert [r["name"] for r in measured] == [f"fig13b_pod_allreduce_{m}MBx4" for m in (1, 4, 16)]
    for r, mb in zip(measured, (1, 4, 16)):
        assert r["model_s"] == topology.collective_seconds("all_reduce", mb << 20, "pod", 4)
        assert r["measured_on"] == "ranks on one card's streams" and r["us_per_call"] > 0
    with pytest.raises(ValueError):
        d2d_rows.run(DeviceMesh({"data": 2}, device="cpu"))
