"""``flush_rows_ms``: the host's time a flush spends on its row tickets:
the program's ``serve.flush.rows`` spans (each ticket's upload, ``z[rows]``
gather and copy to the host, then the concatenation and padding),
averaged over the flushes of the window's traced part.  Moves
``queries_per_s``."""


def read(ctx):
    spans = [s for s in ctx.get("spans") or ()
             if s.name == "serve.flush.rows"]
    if not spans:
        return None
    return sum(s.dur_us for s in spans) * 1e-3 / len(spans)
