"""The card's mean power over the traced slices, from its energy counter
(``perfbench.energy``), in W."""


def read(run):
    tr = run.tracer
    if tr is None or not tr.energy_slices:
        return None
    joules = sum(j for j, _ in tr.energy_slices)
    secs = sum(s for _, s in tr.energy_slices)
    return joules / secs if secs > 0 else None
