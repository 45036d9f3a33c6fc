"""mfu.gcn: the FLOPs of every whole-graph forward the window completed
(both layers' GEMM and SpMM, ``lib/counts.gcn_forward_flops``) over the
window at the card's fp32 peak (exact fp32: no TF32), in percent."""
from portbench.lib import counts
from portbench.lib.readers import share_of_peak


def read(run):
    w = run.window
    return share_of_peak(run, w["forwards"] * counts.gcn_forward_flops(run.model), w["seconds"])
