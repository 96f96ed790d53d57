"""The median of every gap between consecutive tokens of every request in
the window, in ms: a gap that ends in the window, and one still open at its
close with its length so far (``harness.tpot_samples``)."""
import numpy as np

from perfbench import harness


def read(run):
    r = run.rec
    gaps = harness.tpot_samples(r.token_times, set(r.active), r.ws, r.we)
    if not gaps:
        return None
    return float(np.percentile(gaps, 50)) * 1e3
