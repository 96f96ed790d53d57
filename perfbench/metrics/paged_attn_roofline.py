"""The paged decode kernel's share of its roofline over the traced steps:
its bound (``counts.paged_bytes`` a layer, at the card's HBM bandwidth)
over the time of its kernels (the walk and the merge), in %."""

KERNELS = ("paged_attention_kernel", "paged_attention_combine_kernel")


def read(run):
    bw = run.counts.peak(run.peaks, run.kind)["hbm_bytes_per_s"]
    bound = spent = 0.0
    for s in run.window_steps:
        if s.kernels is None or not s.n_active:
            continue
        t = sum(e - b for n, b, e in s.kernels if any(k in n for k in KERNELS))
        if t <= 0:
            continue
        bound += run.model["n_layers"] * run.counts.paged_bytes(run.model, s.n_active, s.live) / bw
        spent += t
    return 100.0 * bound / spent if spent else None
