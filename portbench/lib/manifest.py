"""Where the benchmark finds its parts: ``BENCHMARK.json`` at the checkout's
root names the cells, and each cell's configuration, traffic mix and
per-layer metrics are files found by name:

    portbench/configs/<config>.json     sizes as run (the ``file`` of the entry)
    portbench/reference/<config>.py     its plain reference and input maker
    portbench/traffic/<traffic>.json    the mix's parameters; ``drive`` names
                                        the loop in portbench/drive/<drive>.py
    portbench/metrics/<metric>.py       one reader a per-layer metric

Nothing here imports torch, so the CPU tests and the checks of the
manifest run without it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier
    (``metrics/mfu.prefill.py``, ``reference/occamy-gptj.py``)."""
    key = f"portbench_{path.parent.name}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    mod = sys.modules.get(key)
    if mod is None:
        if not path.exists():
            raise FileNotFoundError(f"{path} (named by the manifest) is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def reference(config_name: str):
    return load_module(BENCH / "reference" / f"{config_name}.py", config_name)


def drive(name: str):
    return load_module(BENCH / "drive" / f"{name}.py", name)


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", name)


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def applies(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` list applies to those cells only."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file's contents
    traffic_name: str
    traffic: dict
    end_to_end: list  # the manifest's metric entries that apply to the cell
    per_layer: list


def cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the manifest has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / conf["file"]), traffic_name=w["traffic"],
        traffic=traffic(w["traffic"]),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)],
    )
