"""``host_enqueue_ms.refit``: the host's time inside one
``fit_transform`` call (the benchmark's clock around the call, with no
sync of its own), averaged over the fits of the window's first, untraced
part.  Where it nears ``fit_ms`` the host, or a wait inside the call, paces
the fits.  Moves ``fit_ms``."""


def read(ctx):
    samples = ctx.get("host", {}).get("enqueue_ms")
    if not samples:
        return None
    return sum(samples) / len(samples)
