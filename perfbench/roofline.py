"""The cards' peaks and the work a fit and a flush need, reckoned from
their inputs (never from the program's packed planes), so a share reads
the same work whatever implements it.

Peaks: one data file a card, ``perfbench/peaks/<kind>.json``, with the
name ``torch.cuda.get_device_name`` gives (every character outside
letters, digits, ``_``, ``.`` and ``-`` as ``_``), holding ``bytes_per_s``,
``f32_flops`` and their source; a new card is a new file.  A card set
below its full power limit runs slower under load; the run prints the
card's power limit beside its numbers.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

PEAKS_DIR = Path(__file__).resolve().parent / "peaks"


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    raises ``KeyError`` for a card that has no file."""
    path = PEAKS_DIR / (re.sub(r"[^A-Za-z0-9_.-]", "_", kind) + ".json")
    try:
        data = json.loads(path.read_text())
    except FileNotFoundError:
        held = sorted(p.stem for p in PEAKS_DIR.glob("*.json"))
        raise KeyError(f"no peaks for {kind!r}; {PEAKS_DIR} holds "
                       f"{held}") from None
    return {"bytes_per_s": float(data["bytes_per_s"]),
            "f32_flops": float(data["f32_flops"])}


def fit_bytes(num_directed_edges: int, num_nodes: int,
              num_classes: int) -> int:
    """Bytes one GEE fit must move at least: each directed edge's neighbour
    index and weight (4 + 4 B), each vertex's label (4 B), and the [N, K]
    f32 embedding written once.  The same under every option setting:
    self loops, degrees and the Laplacian scaling follow from these."""
    return 8 * int(num_directed_edges) + 4 * int(num_nodes) \
        + 4 * int(num_nodes) * int(num_classes)


def fit_flops(num_directed_edges: int, num_nodes: int,
              num_classes: int) -> int:
    """Operations of one fit: a multiply and an add an edge, and the
    K-wide row norm (3 a class) of every vertex."""
    return 2 * int(num_directed_edges) \
        + 3 * int(num_nodes) * int(num_classes)


def flush_bytes(distinct_rows: int, num_queries: int, dim: int,
                k: int) -> int:
    """Bytes one similarity flush must move at least: every database row
    that some query of the flush probes, read once (``distinct_rows`` x K
    f32), the queries (Q x K f32) and the answers written once (Q x k ids
    and scores)."""
    return 4 * int(dim) * (int(distinct_rows) + int(num_queries)) \
        + 8 * int(num_queries) * int(k)


def flush_flops(pairs: int, distinct_rows: int, num_queries: int,
                dim: int) -> int:
    """Operations of one flush at least: for each (query, candidate) pair
    the dot product (2K) and the l2 combine (2); each row's and each
    query's squared norm once (2K)."""
    return int(pairs) * (2 * int(dim) + 2) \
        + 2 * int(dim) * (int(distinct_rows) + int(num_queries))


def bound_seconds(bytes_: float, flops: float, peak: dict) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    return max(bytes_ / peak["bytes_per_s"], flops / peak["f32_flops"])


__all__ = ["PEAKS_DIR", "peaks", "fit_bytes", "fit_flops", "flush_bytes",
           "flush_flops", "bound_seconds"]
