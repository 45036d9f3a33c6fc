"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's ``repro_torch`` is not ``repro``), and the
plain references import nothing of the port either."""
import ast
import subprocess
import sys

import pytest

from portbench.lib import manifest as mf

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(mf.BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(mf.BENCH)) for p in FILES])
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((mf.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert not _imports(path) & (FORBIDDEN | {"repro_torch", "portbench"})


def test_a_run_loads_no_jax():
    """A whole run (on the CPU, at a test's size) leaves no module of JAX
    or the JAX package in the process."""
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r, %r];"
        "from conftest import tiny_cell; from portbench.lib import harness;"
        "harness.run_cell(tiny_cell('prefill'), seed=3, seconds=0.2, trace=False,"
        " device=torch.device('cpu'), t0=time.perf_counter());"
        "print(harness.forbidden_modules())"
    ) % (str(mf.BENCH / "tests"), str(mf.ROOT), str(mf.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
