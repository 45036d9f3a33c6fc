"""gemm_roofline.gcn: the GCN's dense products' least time (each layer's
(nodes x f_in) @ (f_in x f_out) at the fp32 peak; they are bound by
operations) over the device time of the GEMM kernels, in percent."""
from portbench.lib import counts
from portbench.lib.readers import kernel_busy_s, share_of_peak

PATTERNS = (r"(?i)gemm", r"nvjet", r"xmma", r"cutlass")


def read(run):
    busy = kernel_busy_s(run, PATTERNS)
    if busy is None:
        return None
    g = run.model
    dims = g["feature_dims"]
    flops = run.traced["forwards"] * sum(counts.gcn_gemm_flops(g["nodes"], a, b)
                                         for a, b in zip(dims[:-1], dims[1:]))
    return share_of_peak(run, flops, busy)
