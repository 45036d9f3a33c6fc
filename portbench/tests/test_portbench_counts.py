"""The yardstick's frozen peaks and closed-form counts against the port's
own arithmetic (``core/topology.py``, ``launch/roofline.bound_ms``,
``launch/step_count.py``) at the cells' shapes, and every kernel of
``csrc/`` known to a metric's name patterns or listed as unclassified."""
import math
import re

import pytest

from portbench.lib import counts, peaks
from portbench.lib import manifest as mf

GPTJ = mf.load_json(mf.BENCH / "configs" / "occamy-gptj.json")["model"]
GRAPH = mf.load_json(mf.BENCH / "configs" / "gcn-uniform.json")["model"]

# kernels no per-layer metric reads yet: no cell runs them
UNCLASSIFIED = {
    "fa_scaled_wgmma_kernel", "fa_scaled_ffma_kernel", "transpose_u8_kernel",
    "la_chunk_state", "la_state_pass", "la_output",
    "hop_words_kernel", "hop_bytes_kernel", "hop_bulk_kernel",
    "spmspm_count", "spmspm_scan", "spmspm_scatter", "spmspm_rows",
    "stencil_march_kernel", "stencil_direct_kernel",
}


def test_peaks_are_the_ports():
    from repro_torch.core import topology

    assert peaks.FLOPS["bfloat16"] == topology.PEAK_FLOPS_BF16
    assert peaks.HBM_BYTES_PER_S == topology.HBM_BW
    assert peaks.FLOPS["float32"] == 67e12


def test_prefill_flops_against_the_step_counter():
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.hopper.partition import MeshSpec
    from repro_torch.launch import step_count

    got = counts.prefill_flops(GPTJ, 8, 2048)
    c = step_count.count_step(get_config("occamy-gptj"), ShapeSpec("p", "prefill", 2048, 8),
                              MeshSpec({"data": 1, "model": 1}))
    assert got["proj"] == c["matmul_flops"]
    pairs = step_count.attention_pairs(2048, 2048, causal=True, window=0, q_offset=0, bq=1, bk=1)
    assert pairs == counts.causal_pairs(2048)
    # the counter prices the FA kernel by whole tiles, so at or above the pairs
    assert got["attn"] <= c["kernel_flops"]["flash_attention"] < 1.1 * got["attn"]
    assert f"{got['total']:.4g}" == "1.992e+14" and f"{got['proj']:.4g}" == "1.915e+14"
    assert f"{got['attn']:.3g}" == "7.7e+12"


def test_gcn_bounds_against_the_roofline():
    from repro_torch.launch import roofline

    n, L, dims = GRAPH["nodes"], GRAPH["ell_slots"], GRAPH["feature_dims"]
    assert dims == [128, 144, 144]
    for a, b, want in ((128, 144, 0.0932), (144, 144, 0.1048)):
        gemm_flops = counts.gcn_gemm_flops(n, a, b)
        ms, by = roofline.bound_ms(gemm_flops, (n * a + n * b + a * b) * 4,
                                   peak_flops=peaks.FLOPS["float32"])
        assert by == "operations" and round(ms, 4) == want
        assert math.isclose(gemm_flops / peaks.FLOPS["float32"] * 1e3, ms)
    nbytes = counts.gcn_spmm_bytes(n, L, 144)
    ms, by = roofline.bound_ms(counts.gcn_spmm_flops(n, L, 144), nbytes, peak_flops=peaks.FLOPS["float32"])
    assert by == "bytes" and round(ms, 4) == 0.0643
    assert f"{counts.gcn_forward_flops(GRAPH):.4g}" == "1.473e+10"


def test_decode_bytes():
    m = GPTJ
    assert counts.kv_bytes_per_token(m) == 458752
    assert f"{counts.weight_bytes(m) / 1e9:.3g}" == "11.7"
    # the weights of a step are the whole model but the embedding
    assert counts.matmul_params(m) + 50432 * 4096 == pytest.approx(6.05e9, rel=0.01)


def _kernel_names():
    root = mf.ROOT / "src" / "repro_torch" / "csrc"
    rx = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return {n for f in sorted(root.glob("*.cu")) for n in rx.findall(f.read_text())}


def test_every_kernel_is_classified():
    patterns = []
    for path in sorted((mf.BENCH / "metrics").glob("*.py")):
        patterns += getattr(mf.metric_reader(path.stem), "PATTERNS", ())
    names = _kernel_names()
    assert len(names) >= 25
    for n in sorted(names):
        matched = any(re.search(p, n) for p in patterns)
        assert matched != (n in UNCLASSIFIED), n
    assert UNCLASSIFIED <= names
