"""``fit_api_self_ms``: the host's time in the API's own code a fit: the
self time of the program's ``api.fit`` and ``api.transform`` spans (their
duration less their children's: ``api.labels``, ``plan.build`` and
``plan.execute``), summed over the window's traced part and averaged over
its fits (``api.fit`` spans).  Moves ``fit_ms``."""


def read(ctx):
    spans = ctx.get("spans") or ()
    fits = sum(1 for s in spans if s.name == "api.fit")
    if not fits:
        return None
    ids = {s.span_id: s for s in spans if s.name in ("api.fit",
                                                     "api.transform")}
    us = sum(s.dur_us for s in ids.values())
    us -= sum(s.dur_us for s in spans
              if getattr(s, "parent_id", None) in ids)
    return us * 1e-3 / fits
