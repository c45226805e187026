"""``fit_prep_host_ms``: the host's time in the device prep passes a fit:
the program's ``prep.*`` spans (class weights, degrees, and per bucket the
Laplacian values, the kernel planes and the diag-aug addend; the residual
fixup), summed over the window's traced part and averaged over its fits
(``plan.execute`` spans).  Moves ``fit_ms``."""


def read(ctx):
    spans = ctx.get("spans") or ()
    prep = [s for s in spans if s.name.startswith("prep.")]
    fits = sum(1 for s in spans if s.name == "plan.execute")
    if not prep or not fits:
        return None
    return sum(s.dur_us for s in prep) * 1e-3 / fits
