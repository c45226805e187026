"""Serving: the LM decode server (``decode``, ``batching``) and crash-safe
GEE serving (the write-ahead log, snapshots, recovery, read replicas)."""
