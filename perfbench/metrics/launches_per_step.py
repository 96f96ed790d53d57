"""Device operations a decode step launches, counted from the profiler's
device records: those that start between the step's start and its last
token hook (sampling included), over the traced steps."""


def read(run):
    steps = [s for s in run.window_steps if s.kernels is not None]
    if not steps:
        return None
    return sum(len(s.kernels) for s in steps) / len(steps)
