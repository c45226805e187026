"""Masked similarity scoring and top-k for vertex retrieval (port of
``repro/kernels/topk_score.py``).

Four wrappers, each over a CUDA kernel in ``csrc/topk_kernels.cu``:

  ``pairwise_scores``       replaces ``_pairwise_kernel``: [Q, M] scores of
                            queries [Q, K] against a shared database [M, K]
  ``gathered_scores``       replaces ``_gathered_kernel``: the same against
                            per-query candidates [Q, M, K] (the IVF gather)
  ``scored_topk``           replaces ``_pairwise_topk_kernel``:
                            ``masked_topk(pairwise_scores(...), None, k)``
                            without the [Q, M] scores in device memory
  ``scored_topk_gathered``  replaces ``_gathered_topk_kernel``:
                            ``masked_topk(gathered_scores(...), ids, k)``

Metrics: ``l2`` (−‖q − x‖², higher is closer) and ``cosine``.  Masked slots
score ``NEG_INF``; ``masked_topk`` (plain torch, as in the reference) gives
them id −1.

Bound on the H100: bytes (K is a handful of classes).  The top-k kernels
rank by score, then by candidate position, so any merge order reproduces
the reference's stable tie order; see the source for the two-pass design.

A CPU tensor takes the plain version (``repro_torch.kernels.ref``); a CUDA
tensor launches the kernel or raises.  The one other route is open and
documented: a top-k wider than ``MAX_TOPK`` (``min(k, M) > MAX_TOPK``), or
``fused=False``, runs the staged kernels (``pairwise_scores`` /
``gathered_scores``, then ``masked_topk``).  The TPU block tables and their
autotune registry stay behind: they are TPU geometry.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import (check_launch, check_tensor,
                                      load_library, stream_of)
from repro_torch.kernels.gee_fused import fused_override
from repro_torch.kernels.ref import (NEG_INF, gathered_scores_ref,
                                     masked_topk, pairwise_scores_ref,
                                     scored_topk_gathered_ref,
                                     scored_topk_ref)

METRICS = ("l2", "cosine")
_METRIC_CODE = {"l2": 0, "cosine": 1}

# The widest top-k the fused kernels keep (``kMaxTopK`` in
# csrc/topk_kernels.cu): each of a block's 128 threads holds a private list
# of up to 32 (score, position) pairs, and the block merges them in 32 KiB
# of shared memory.
MAX_TOPK = 32
# The top-k kernels split M into chunks so that a 64-query flush still
# fills the card: about this many blocks per SM, and never fewer than this
# many candidates a block.
_BLOCKS_PER_SM = 8
_MIN_CHUNK = 1024


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; pick one of {METRICS}")


def _check_k(k: int) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return k


def _mask_operand(mask: torch.Tensor | None, name: str, shape: tuple,
                  device: torch.device) -> torch.Tensor | None:
    """A valid/mask operand as contiguous f32 on ``device`` (nonzero =
    live); ``None`` stays ``None``."""
    if mask is None:
        return None
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tuple(mask.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(mask.shape)}, expected "
                         f"{shape}")
    if mask.device != device:
        raise ValueError(f"{name} is on {mask.device}, expected {device}")
    return mask.to(torch.float32).contiguous()


def _check_queries(queries: torch.Tensor, other: torch.Tensor,
                   other_name: str) -> None:
    check_tensor(queries, "queries", torch.float32, 2)
    if other.device != queries.device:
        raise ValueError(f"{other_name} is on {other.device}, expected "
                         f"{queries.device}")
    if other.shape[-1] != queries.shape[1]:
        raise ValueError(f"{other_name} has K={other.shape[-1]}, queries "
                         f"K={queries.shape[1]}")


def _check_cand(cand: torch.Tensor, queries: torch.Tensor) -> None:
    check_tensor(cand, "cand", torch.float32, 3)
    if cand.shape[0] != queries.shape[0]:
        raise ValueError(f"cand has {cand.shape[0]} rows, queries "
                         f"{queries.shape[0]}")


def fused_topk_enabled(device) -> bool:
    """Whether a search on ``device`` takes the fused score-and-top-k
    kernels: the ``REPRO_GEE_FUSED`` override wins when set; otherwise fused
    iff the device is ``cuda``."""
    override = fused_override()
    if override is not None:
        return bool(override)
    return torch.device(device).type == "cuda"


def _fused_route(fused: bool, k: int, m: int) -> bool:
    """The fused kernels take ``min(k, M) <= MAX_TOPK``; wider top-ks (and
    ``fused=False``) take the staged kernels."""
    return bool(fused) and min(k, m) <= MAX_TOPK


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _num_chunks(device: torch.device, q: int, m: int) -> int:
    """How many chunks the top-k kernels split each query's M into."""
    want = -(-_BLOCKS_PER_SM * _sm_count(device) // q)
    most = -(-m // _MIN_CHUNK)
    return max(1, min(want, most))


# ---------------------------------------------------------------------------
# the score kernels
# ---------------------------------------------------------------------------

def pairwise_scores(queries: torch.Tensor, database: torch.Tensor,
                    valid: torch.Tensor | None = None, *,
                    metric: str = "l2") -> torch.Tensor:
    """Masked [Q, M] score matrix of ``queries`` [Q, K] f32 against a shared
    ``database`` [M, K] f32.  ``valid`` [M] (nonzero = live) sends rows to
    ``NEG_INF``; ``None`` means all live."""
    _check_metric(metric)
    _check_queries(queries, database, "database")
    check_tensor(database, "database", torch.float32, 2)
    q, m = queries.shape[0], database.shape[0]
    valid = _mask_operand(valid, "valid", (m,), queries.device)
    if queries.device.type == "cpu":
        return pairwise_scores_ref(queries, database, valid, metric)
    out = torch.empty((q, m), dtype=torch.float32, device=queries.device)
    if q * m == 0:
        return out
    lib = load_library()
    rc = lib.pairwise_scores_launch(
        queries.data_ptr(), database.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(), q, m,
        queries.shape[1], _METRIC_CODE[metric], stream_of(queries))
    check_launch(lib, rc, "pairwise_scores")
    pairwise_scores.launches += 1
    return out


pairwise_scores.launches = 0


def gathered_scores(queries: torch.Tensor, cand: torch.Tensor,
                    mask: torch.Tensor, *,
                    metric: str = "l2") -> torch.Tensor:
    """Masked [Q, M] scores of ``queries`` [Q, K] f32 against per-query
    candidates ``cand`` [Q, M, K] f32; ``mask`` [Q, M] (nonzero = live)
    sends padding slots to ``NEG_INF``."""
    _check_metric(metric)
    _check_queries(queries, cand, "cand")
    _check_cand(cand, queries)
    q, m = cand.shape[0], cand.shape[1]
    mask = _mask_operand(mask, "mask", (q, m), queries.device)
    if queries.device.type == "cpu":
        return gathered_scores_ref(queries, cand, mask, metric)
    out = torch.empty((q, m), dtype=torch.float32, device=queries.device)
    if q * m == 0:
        return out
    lib = load_library()
    rc = lib.gathered_scores_launch(
        cand.data_ptr(), queries.data_ptr(), mask.data_ptr(), out.data_ptr(),
        q, m, queries.shape[1], _METRIC_CODE[metric], stream_of(queries))
    check_launch(lib, rc, "gathered_scores")
    gathered_scores.launches += 1
    return out


gathered_scores.launches = 0


# ---------------------------------------------------------------------------
# the fused score-and-top-k kernels
# ---------------------------------------------------------------------------

def _empty_topk(q: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((q, k), -1, dtype=torch.int32, device=device),
            torch.full((q, k), NEG_INF, dtype=torch.float32, device=device))


def _topk_outputs(q: int, m: int, k: int, device):
    """(out_ids, out_scores, part_s, part_m, chunks) for a top-k launch; the
    partial lists are scratch for the chunks' merge (absent at 1 chunk)."""
    chunks = _num_chunks(device, q, m)
    kk = min(k, m)
    out_ids, out_s = (torch.empty((q, k), dtype=dt, device=device)
                      for dt in (torch.int32, torch.float32))
    part_s = part_m = None
    if chunks > 1:
        part_s = torch.empty((q, chunks, kk), dtype=torch.float32,
                             device=device)
        part_m = torch.empty((q, chunks, kk), dtype=torch.int32,
                             device=device)
    return out_ids, out_s, part_s, part_m, chunks


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def scored_topk(queries: torch.Tensor, database: torch.Tensor,
                valid: torch.Tensor | None, k: int, *, metric: str = "l2",
                fused: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of ``queries`` [Q, K] against a shared ``database``
    [M, K]: exactly ``masked_topk(pairwise_scores(...), None, k)``, returned
    as ``(ids [Q, k] int32, scores [Q, k] f32)``.  ``fused=None`` resolves
    through :func:`fused_topk_enabled`."""
    _check_metric(metric)
    k = _check_k(k)
    _check_queries(queries, database, "database")
    check_tensor(database, "database", torch.float32, 2)
    q, m = queries.shape[0], database.shape[0]
    valid = _mask_operand(valid, "valid", (m,), queries.device)
    if fused is None:
        fused = fused_topk_enabled(queries.device)
    if not _fused_route(fused, k, m):
        return masked_topk(pairwise_scores(queries, database, valid,
                                           metric=metric), None, k)
    if queries.device.type == "cpu":
        return scored_topk_ref(queries, database, valid, k, metric)
    if q == 0 or m == 0:
        return _empty_topk(q, k, queries.device)
    out_ids, out_s, part_s, part_m, chunks = _topk_outputs(
        q, m, k, queries.device)
    lib = load_library()
    rc = lib.scored_topk_launch(
        queries.data_ptr(), database.data_ptr(), _ptr(valid), _ptr(part_s),
        _ptr(part_m), out_s.data_ptr(), out_ids.data_ptr(), q, m,
        queries.shape[1], _METRIC_CODE[metric], k, chunks,
        stream_of(queries))
    check_launch(lib, rc, "scored_topk")
    scored_topk.launches += 1
    return out_ids, out_s


scored_topk.launches = 0


def scored_topk_gathered(queries: torch.Tensor, cand: torch.Tensor,
                         mask: torch.Tensor, ids: torch.Tensor, k: int, *,
                         metric: str = "l2", fused: bool | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query-candidates twin of :func:`scored_topk` (the IVF path):
    ``masked_topk(gathered_scores(...), ids, k)``, with ``ids`` [Q, M]
    int32 each candidate's database id."""
    _check_metric(metric)
    k = _check_k(k)
    _check_queries(queries, cand, "cand")
    _check_cand(cand, queries)
    q, m = cand.shape[0], cand.shape[1]
    mask = _mask_operand(mask, "mask", (q, m), queries.device)
    check_tensor(ids, "ids", torch.int32, 2, like=mask)
    if fused is None:
        fused = fused_topk_enabled(queries.device)
    if not _fused_route(fused, k, m):
        return masked_topk(gathered_scores(queries, cand, mask,
                                           metric=metric), ids, k)
    if queries.device.type == "cpu":
        return scored_topk_gathered_ref(queries, cand, mask, ids, k, metric)
    if q == 0 or m == 0:
        return _empty_topk(q, k, queries.device)
    out_ids, out_s, part_s, part_m, chunks = _topk_outputs(
        q, m, k, queries.device)
    lib = load_library()
    rc = lib.scored_topk_gathered_launch(
        cand.data_ptr(), queries.data_ptr(), mask.data_ptr(), ids.data_ptr(),
        _ptr(part_s), _ptr(part_m), out_s.data_ptr(), out_ids.data_ptr(), q,
        m, queries.shape[1], _METRIC_CODE[metric], k, chunks,
        stream_of(queries))
    check_launch(lib, rc, "scored_topk_gathered")
    scored_topk_gathered.launches += 1
    return out_ids, out_s


scored_topk_gathered.launches = 0


__all__ = ["METRICS", "NEG_INF", "MAX_TOPK", "fused_topk_enabled",
           "pairwise_scores", "gathered_scores", "scored_topk",
           "scored_topk_gathered", "masked_topk"]
