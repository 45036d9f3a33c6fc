"""On the card: each cell's control (the reference in the precision below
the configuration's, in the program's place) comes out not correct, at the
cell's own sizes and load, while the program on the same seed comes out
correct. The prefill and GCN windows are the shortest that compare as much
as a run does; the serving cell's is a run's own, so that it finishes and
compares requests as long as a run's. Skips without a card.

    python -m pytest -q -m cuda portbench/tests/test_portbench_control.py
"""
import time

import pytest
import torch

from portbench.lib import harness
from portbench.lib import manifest as mf

WINDOW = {"gptj.prefill": 5.0, "gcn.uniform": 3.0, "gptj.serve": 51.0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WINDOW))
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes")
    cell = mf.cell(mf.load_manifest(), name)
    for control, want in ((None, True), (cell.config["control"], False)):
        r = harness.run_cell(cell, seed=2**31 + 99, seconds=WINDOW[name], trace=False,
                             device=torch.device("cuda", 0), t0=time.perf_counter(),
                             control=control)
        assert r["correct"] is want, (control, r["checks"])
        torch.cuda.empty_cache()
