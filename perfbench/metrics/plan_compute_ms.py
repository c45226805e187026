"""``plan_compute_ms``: the program's ``plan.stage.*`` spans of kind
``compute`` (the contraction with its device prep passes), which sync the
card at their end when traced, summed and averaged over the fits
(``plan.execute`` spans) of the window's traced part.  Moves ``fit_ms``."""


def read(ctx):
    spans = ctx.get("spans") or ()
    fits = sum(1 for s in spans if s.name == "plan.execute")
    if not fits:
        return None
    us = sum(s.dur_us for s in spans if s.name.startswith("plan.stage.")
             and s.args.get("kind") == "compute")
    return us * 1e-3 / fits
