"""Crash-safe GEE serving: the write-ahead log, snapshots, recovery and
read replicas."""
