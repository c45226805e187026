"""``pack_ms``: the host packing into degree buckets and its upload, summed
over the run (set-up's packing): the program's ``pack.bucketed_ell_ms``
histogram in its global registry, observed once a packing whether or not
the tracer is on.  Moves ``setup_s``."""


def read(ctx):
    from repro_torch.obs import metrics

    hist = metrics.get_registry().snapshot()["histograms"].get(
        "pack.bucketed_ell_ms")
    if not hist or not hist["count"]:
        return None
    return hist["sum"]
