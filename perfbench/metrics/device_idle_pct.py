"""The share of the traced slices in which no operation runs on the card
(the union of the profiler's device intervals), in %."""


def read(run):
    tr = run.tracer
    if tr is None or not tr.slices:
        return None
    win = sum(hi - lo for lo, hi in tr.slices)
    busy = sum(run.union_busy(tr.kernels, lo, hi)[0] for lo, hi in tr.slices)
    return 100.0 * (1.0 - busy / win)
