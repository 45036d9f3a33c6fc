"""fa_roofline.prefill: the causal attention FLOPs (QK^T and PV over the
pairs a query attends to) of the traced slice's forwards at the bf16
peak, over the device time of the attention kernels, in percent."""
from portbench.lib import counts
from portbench.lib.readers import kernel_busy_s, share_of_peak

PATTERNS = (r"fa_fwd", r"(?i)flash", r"fmha")


def read(run):
    busy = kernel_busy_s(run, PATTERNS)
    if busy is None:
        return None
    t = run.cell.traffic
    flops = run.traced["forwards"] * counts.prefill_flops(run.model, t["batch"], t["seq"])["attn"]
    return share_of_peak(run, flops, busy)
