"""spmm_roofline.gcn: the ELL aggregation's least time (its values and
columns, the dense input and the output, each once, at the card's HBM
rate; it is bound by bytes) over the device time of the SpMM kernels, in
percent."""
from portbench.lib import counts, peaks
from portbench.lib.readers import kernel_busy_s

PATTERNS = (r"ell_gather", r"(?i)spmm")


def read(run):
    busy = kernel_busy_s(run, PATTERNS)
    if busy is None:
        return None
    g = run.model
    nbytes = run.traced["forwards"] * sum(counts.gcn_spmm_bytes(g["nodes"], g["ell_slots"], b)
                                          for b in g["feature_dims"][1:])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / busy
