"""``query_flush_ms``: the program's ``serve.query_flush`` spans (repair,
gather of the query rows, the index search, the copy of the answers to
the host), averaged over the flushes of the window's traced part.  Moves
``queries_per_s``."""


def read(ctx):
    spans = [s for s in ctx.get("spans") or ()
             if s.name == "serve.query_flush"]
    if not spans:
        return None
    return sum(s.dur_us for s in spans) * 1e-3 / len(spans)
