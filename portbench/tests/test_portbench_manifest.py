"""The manifest as the benchmark's contract has it: its keys, names and
units, and every file it names found where the harness looks."""
import json

import pytest

from portbench.lib import manifest as mf

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_parses_with_exact_keys(manifest):
    assert set(manifest) == TOP
    for group, keys in KEYS.items():
        for entry in manifest[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (group, entry.get("name"))
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert mf.NAME_RE.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert mf.UNIT_RE.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    assert len(set(names)) == len(names)
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for w in manifest["workloads"]:
        assert mf.NAME_RE.match(w["config"]) and mf.NAME_RE.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


def test_every_metric_moves_a_metric_its_cells_report(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for c in m.get("workloads", cells):
            assert c in cells
            assert mf.applies(e2e[m["moves"]], c), (m["name"], c)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in manifest["end_to_end"] if mf.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(mf.applies(m, w["name"]) for m in manifest["per_layer"]), w["name"]


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


@pytest.mark.parametrize("cell", ["gptj.prefill", "gcn.uniform", "gptj.serve"])
def test_cell_finds_its_files(manifest, cell):
    c = mf.cell(manifest, cell)
    assert c.config["name"] == c.config_name
    assert (mf.BENCH / "reference" / f"{c.config_name}.py").exists()
    drive = mf.drive(c.traffic["drive"])
    for fn in ("setup", "loop", "end_to_end", "release", "check"):
        assert callable(getattr(drive, fn)), fn
    for m in c.per_layer:
        assert callable(mf.metric_reader(m["name"]).read), m["name"]
    assert c.config["control"] and c.config["limits"]


def test_config_files_lie_under_paths_and_keep_their_widths(manifest):
    for conf in manifest["configs"]:
        assert any(conf["file"].startswith(p + "/") for p in manifest["paths"])
        data = mf.load_json(mf.ROOT / conf["file"])
        assert data["reduced"] == conf["reduced"] and data["source"] == conf["source"]


def test_command_stays_inside_paths(manifest):
    cmd = manifest["command"]
    assert len(cmd) <= 32
    files = [w for w in cmd if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in manifest["paths"]) for f in files)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
