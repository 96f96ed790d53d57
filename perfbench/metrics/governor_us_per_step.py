"""Host microseconds inside the governor's entry point on the bus (its
``on_phase``, timed by the probes subscribed around it), over the window,
per decode step: the paper's overhead, paid on the serving loop's thread."""


def read(run):
    steps = run.window_steps
    if not steps:
        return None
    return run.rec.gov_total / len(steps) * 1e6
