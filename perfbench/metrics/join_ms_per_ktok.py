"""The window's prefill joins, ms per 1000 prompt tokens: each join from
the host's previous instant (the last token hook, probe or join before it)
to the engine's ``join`` instant, which follows the device's work."""


def read(run):
    joins = run.window_joins
    tokens = sum(j.prompt_len for j in joins)
    if not tokens:
        return None
    return sum(j.t1 - j.t0 for j in joins) / tokens * 1e6
