"""ttft_p95_ms.serve: the 95th percentile, over every request whose first
token came in the window, of the time from its submission to the end of
the engine step whose prefill produced that token, in ms."""
import numpy as np


def read(run):
    st, w = run.state, run.window
    waits = [st["first"][r] - st["submitted"][r] for r, at in st["first"].items()
             if w["start"] <= at <= w["stop"]]
    return 1e3 * float(np.percentile(waits, 95)) if waits else None
