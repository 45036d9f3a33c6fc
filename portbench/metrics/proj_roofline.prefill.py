"""proj_roofline.prefill: the projections' and the head's FLOPs of the
traced slice's forwards at the bf16 peak, over the device time of the
GEMM kernels that do that work (cuBLAS under ``torch.matmul``, or the
port's own GEMM), in percent."""
from portbench.lib import counts
from portbench.lib.readers import kernel_busy_s, share_of_peak

PATTERNS = (r"(?i)gemm", r"nvjet", r"xmma", r"cutlass", r"(?i)splitk")


def read(run):
    busy = kernel_busy_s(run, PATTERNS)
    if busy is None:
        return None
    t = run.cell.traffic
    flops = run.traced["forwards"] * counts.prefill_flops(run.model, t["batch"], t["seq"])["proj"]
    return share_of_peak(run, flops, busy)
