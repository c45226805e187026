"""``fit_prep_device_ms``: the device intervals of the program's ``prep.*``
spans (each from the event recorded on the stream as the span opened to
the one recorded as it closed, so it holds the passes' kernels and any
idle time between them), summed over the window's traced part and
averaged over its fits (``plan.execute`` spans).  Moves ``fit_ms``."""


def read(ctx):
    spans = ctx.get("spans") or ()
    dev = [s.dev_dur_us for s in spans if s.name.startswith("prep.")
           and getattr(s, "dev_dur_us", None) is not None]
    fits = sum(1 for s in spans if s.name == "plan.execute")
    if not dev or not fits:
        return None
    return sum(dev) * 1e-3 / fits
