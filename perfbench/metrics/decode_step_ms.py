"""The window's decode steps: the sum of their synchronised durations (the
slack meter's phases, inputs to the device until it is done) over their
count, in ms."""


def read(run):
    steps = run.window_steps
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
