"""Versioned, atomically written array checkpoints and their manager."""
