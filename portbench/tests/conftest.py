"""Shared pieces of the benchmark's tests: the checkout on the path, and
cells of the manifest's drives at sizes the CPU runs in seconds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.lib import manifest as mf  # noqa: E402

TINY_LM = {"name": "tiny", "family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
           "num_kv_heads": 4, "head_dim": 16, "d_ff": 128, "vocab_size": 512,
           "activation": "gelu", "parallel_block": True, "rope_theta": 10000.0,
           "norm_eps": 1e-5, "dtype": "bfloat16"}
TINY_GRAPH = {"nodes": 500, "mean_degree": 4, "ell_slots": 5, "feature_dims": [16, 16, 16],
              "dtype": "float32"}
TINY_TRAFFIC = {
    "prefill": {"drive": "prefill", "batch": 4, "seq": 64, "batches": 2, "keep": 2,
                "trace_seconds": 0.3},
    "graph": {"drive": "graph", "features": 3, "keep": 2, "trace_seconds": 0.3},
    "serve": {"drive": "serve", "clients": 4, "slots": 4, "block_size": 8, "num_blocks": 33,
              "max_blocks_per_seq": 8, "requests": 32, "length_seed": 0,
              "prompt_tokens": [8, 40], "output_tokens": [4, 16], "check_tokens": 30,
              "trace_seconds": 0.3},
}
# the manifest's cell whose metrics each tiny cell reports
REAL = {"prefill": "gptj.prefill", "graph": "gcn.uniform", "serve": "gptj.serve"}


def tiny_cell(drive: str, dtype: str = "bfloat16") -> mf.Cell:
    """The manifest's cell of ``drive`` with its configuration's widths and
    its mix's sizes cut to a CPU test's: limits, control, metrics as
    committed."""
    real = mf.cell(mf.load_manifest(), REAL[drive])
    model = TINY_GRAPH if drive == "graph" else dict(TINY_LM, dtype=dtype)
    return mf.Cell(f"tiny.{drive}", 1, real.config_name, dict(real.config, model=model),
                   f"tiny-{drive}", TINY_TRAFFIC[drive], real.end_to_end, real.per_layer)


@pytest.fixture
def manifest():
    return mf.load_manifest()
