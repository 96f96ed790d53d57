"""The decode steps' share of the card's peak: their model FLOPs (2 x
active parameters x tokens, plus attention over the live positions;
``counts.decode_flops``) over their summed synchronised time x the
published dense bf16 peak, in %."""


def read(run):
    steps = run.window_steps
    if not steps:
        return None
    peak = run.counts.peak(run.peaks, run.kind)["bf16_flops"]
    flops = sum(run.counts.decode_flops(run.model, s.n_active, s.live) for s in steps)
    return 100.0 * flops / (sum(s.t1 - s.t0 for s in steps) * peak)
