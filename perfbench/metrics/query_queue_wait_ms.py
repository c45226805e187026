"""``query_queue_wait_ms``: how long the oldest request of a flush waited
in the queue: the ``oldest_wait_us`` tag of the program's
``serve.query_flush`` spans (from the oldest ticket's submit to the start
of its flush), averaged over the flushes of the window's traced part.
Moves ``queries_per_s``."""


def read(ctx):
    waits = [s.args["oldest_wait_us"] for s in ctx.get("spans") or ()
             if s.name == "serve.query_flush" and "oldest_wait_us" in s.args]
    if not waits:
        return None
    return sum(waits) * 1e-3 / len(waits)
