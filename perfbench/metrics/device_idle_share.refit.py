"""``device_idle_share.refit``: the share of the profiled slice of the
window in which no kernel or copy ran on the card (``torch.profiler``,
the program's tracer off).  Moves ``fit_ms``."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
