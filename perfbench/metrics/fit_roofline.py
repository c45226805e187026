"""``fit_roofline``: the least time a fit could take on this card
(``perfbench/roofline.py``: the bytes and operations reckoned from its
inputs, over the card's peaks) over the device-busy time of one fit in
the profiled slice of the window.  Moves ``fit_ms``."""


def read(ctx):
    prof = ctx.get("profile")
    bound = ctx.get("bound_s_per_unit")
    if not prof or bound is None or prof["busy_s"] <= 0 or not prof["units"]:
        return None
    return 100.0 * bound * prof["units"] / prof["busy_s"]
