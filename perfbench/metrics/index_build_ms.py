"""``index_build_ms``: set-up's ``GEEEmbedder.build_index`` (class
centroids, every vertex's cell, the cell table), host clock ending in a
sync.  Moves ``setup_s``."""


def read(ctx):
    return ctx.get("setup", {}).get("index_build_ms")
