"""The flash prefill kernel's share of its roofline over the traced joins:
for each layer's call the longer of its causal FLOPs at the dense bf16
peak and its must-move bytes at the HBM bandwidth (``counts.flash_*``),
over the kernel's time, in %."""

KERNEL = "flash_attention_kernel"


def read(run):
    row = run.counts.peak(run.peaks, run.kind)
    bound = spent = 0.0
    for j in run.window_joins:
        if j.kernels is None:
            continue
        t = sum(e - b for n, b, e in j.kernels if KERNEL in n)
        if t <= 0:
            continue
        one = max(run.counts.flash_flops(run.model, j.prompt_len) / row["bf16_flops"],
                  run.counts.flash_bytes(run.model, j.prompt_len) / row["hbm_bytes_per_s"])
        bound += run.model["n_layers"] * one
        spent += t
    return 100.0 * bound / spent if spent else None
