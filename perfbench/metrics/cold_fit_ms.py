"""``cold_fit_ms``: set-up's first fit of the graph (host packing into the
bucketed ELL, then the fit), host clock ending with the embedding on the
host.  Moves ``setup_s``."""


def read(ctx):
    return ctx.get("setup", {}).get("cold_fit_ms")
