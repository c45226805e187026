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

The top-k kernels rank by score, then by candidate position, so any merge
order reproduces the reference's stable tie order; both keep their lists in
a warp's registers, ``scored_topk`` one a query of a tile of queries that
share each database row it loads.  The source says what bounds each kernel
on the H100 and what its design does about it.

A CPU tensor takes the plain version (``repro_torch.kernels.ref``); a CUDA
tensor launches the kernel or raises.  The one other route is open and
documented: a top-k wider than ``MAX_TOPK`` (``min(k, M) > MAX_TOPK``), or
``fused=False``, runs the staged kernels (``pairwise_scores`` /
``gathered_scores``, then ``masked_topk``).  The TPU block tables stay
behind: they are TPU geometry.  The top-k kernels' chunk counts resolve
through ``autotune.REGISTRY`` (``cuda.topk_pairwise`` and
``cuda.topk_gathered``, key ``(SMs, Q, M)``), whose fallbacks are the
policies ``_num_chunks`` and ``_gathered_chunks``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.autotune import REGISTRY, measure_enabled
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
# csrc/topk_kernels.cu): one (score, position) entry a lane of a warp.
MAX_TOPK = 32
# The top-k kernels split M into chunks so that a 64-query batch still
# fills the card.  ``scored_topk``: pass-1 blocks of 8 warps, each block a
# tile of ``_QUERY_TILE`` queries (``kQueryTile``) and one chunk; no more
# blocks than the SMs hold at once (``kTopkBlocksPerSm``, which the kernel's
# launch bounds guarantee), and chunks of at least ``_MIN_CHUNK``
# candidates, 4 rounds of the block's 256 lanes taking 2 each.
_QUERY_TILE = 2
_BLOCKS_PER_SM = 2
_MIN_CHUNK = 2048
# ``scored_topk_gathered``: pass-1 blocks of 8 warps (``kGatherWarps``),
# each warp scoring 64 candidates a round; no more blocks than the SMs hold
# at once (``kGatherBlocksPerSm``, which the kernel's launch bounds
# guarantee), so none waits for a second wave, and chunks of at least 2,048
# candidates.
_GATHER_BLOCKS_PER_SM = 4
_GATHER_MIN_CHUNK = 2048


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; pick one of {METRICS}")


def _check_k(k: int) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return k


def _check_mask(mask: torch.Tensor, name: str, shape: tuple,
                device: torch.device) -> None:
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tuple(mask.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(mask.shape)}, expected "
                         f"{shape}")
    if mask.device != device:
        raise ValueError(f"{name} is on {mask.device}, expected {device}")


def _mask_operand(mask: torch.Tensor | None, name: str, shape: tuple,
                  device: torch.device) -> torch.Tensor | None:
    """A valid/mask operand as contiguous f32 on ``device`` (> 0 = live);
    ``None`` stays ``None``."""
    if mask is None:
        return None
    _check_mask(mask, name, shape, device)
    return mask.to(torch.float32).contiguous()


# the dtypes the kernels read as they are, and their size in bytes
_VALID_BYTES = {torch.bool: 1, torch.uint8: 1, torch.float32: 4}


def _valid_operand(valid: torch.Tensor | None, m: int, device: torch.device
                   ) -> tuple[torch.Tensor | None, int]:
    """``valid`` [M] as the kernels read it, and its element size: bool
    and uint8 (nonzero = live) and f32 (> 0 = live) as they are, so a
    call launches no cast; any other dtype cast to f32 (> 0 = live, as
    the plain version reads it)."""
    if valid is None:
        return None, 0
    _check_mask(valid, "valid", (m,), device)
    if valid.dtype not in _VALID_BYTES:
        valid = valid.to(torch.float32)
    return valid.contiguous(), _VALID_BYTES[valid.dtype]


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


def _pairwise_policy(sms: int, q: int, m: int) -> int:
    fit = _BLOCKS_PER_SM * sms // -(-q // _QUERY_TILE)
    return max(1, min(fit, -(-m // _MIN_CHUNK)))


def _gathered_policy(sms: int, q: int, m: int) -> int:
    fit = _GATHER_BLOCKS_PER_SM * sms // q
    return max(1, min(fit, -(-m // _GATHER_MIN_CHUNK)))


def _num_chunks(device: torch.device, q: int, m: int) -> int:
    """How many chunks ``scored_topk`` splits M into: its ceil(Q /
    ``_QUERY_TILE``) query tiles times the chunks at most
    ``_BLOCKS_PER_SM`` blocks an SM in all, none shorter than
    ``_MIN_CHUNK`` candidates (but always one)."""
    return _pairwise_policy(_sm_count(device), q, m)


def _gathered_chunks(device: torch.device, q: int, m: int) -> int:
    """How many chunks ``scored_topk_gathered`` splits each query's M into:
    at most ``_GATHER_BLOCKS_PER_SM`` blocks an SM in all, none shorter than
    ``_GATHER_MIN_CHUNK`` candidates (but always one)."""
    return _gathered_policy(_sm_count(device), q, m)


PAIRWISE_KERNEL = "cuda.topk_pairwise"
GATHERED_KERNEL = "cuda.topk_gathered"
_KERNEL_OF = {"scored_topk": PAIRWISE_KERNEL,
              "scored_topk_gathered": GATHERED_KERNEL}
REGISTRY.register(PAIRWISE_KERNEL,
                  fallback=lambda key: (_pairwise_policy(*key),))
REGISTRY.register(GATHERED_KERNEL,
                  fallback=lambda key: (_gathered_policy(*key),))


def chunks_key(device: torch.device, q: int, m: int) -> tuple[int, ...]:
    """The registry key of a top-k launch: the card's SM count (the
    policies read it), Q and M."""
    return (_sm_count(device), int(q), int(m))


def resolve_chunks(kernel: str, device: torch.device, q: int, m: int) -> int:
    """The chunk count of a launch of ``kernel`` (``PAIRWISE_KERNEL`` or
    ``GATHERED_KERNEL``) through ``REGISTRY``."""
    value = REGISTRY.lookup(kernel, chunks_key(device, q, m))
    if len(value) != 1 or value[0] < 1:
        raise ValueError(f"{kernel}: chunk count {value} is not one int >= 1")
    return value[0]


def chunk_candidates(kernel: str, device: torch.device, q: int,
                     m: int) -> list[tuple[int]]:
    """The measured search's candidates: the current resolution first,
    then 1 to 64 chunks by powers of two, no more chunks than M."""
    out = [(resolve_chunks(kernel, device, q, m),)]
    out += [(c,) for c in (1, 2, 4, 8, 16, 32, 64)
            if c <= m and (c,) not in out]
    return out


def measured_chunks_search(name: str, args: tuple, kwargs: dict | None = None,
                           *, repeats: int = 3, persist: bool = True):
    """Time ``scored_topk`` or ``scored_topk_gathered`` (``name``) on one
    call's CUDA operands ``args``/``kwargs`` at each candidate chunk count
    by CUDA events, and record the fastest under the call's key.  Returns
    ``(winner, {(chunks,): seconds})``."""
    queries, other = args[0], args[1]
    q, m = queries.shape[0], other.shape[-2]
    kernel = _KERNEL_OF[name]
    fn = {"scored_topk": scored_topk,
          "scored_topk_gathered": scored_topk_gathered}[name]

    def run(c):
        return fn(*args, **(kwargs or {}), chunks=int(c[0]))

    return REGISTRY.measured_search(
        kernel, chunks_key(queries.device, q, m),
        chunk_candidates(kernel, queries.device, q, m), run, repeats=repeats,
        persist=persist)


def _launch_chunks(name: str, args: tuple, kwargs: dict,
                   chunks: int | None) -> int:
    """A launch's chunk count: ``chunks`` when given, else the registry's
    (after a measured search of the call when ``REPRO_AUTOTUNE_MEASURE`` opts
    in and its key is not recorded)."""
    if chunks is not None:
        if int(chunks) < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        return int(chunks)
    queries, other = args[0], args[1]
    q, m = queries.shape[0], other.shape[-2]
    kernel = _KERNEL_OF[name]
    if measure_enabled() and chunks_key(queries.device, q, m) \
            not in REGISTRY.recorded(kernel):
        measured_chunks_search(name, args, kwargs)
    return resolve_chunks(kernel, queries.device, q, m)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


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
    valid, valid_bytes = _valid_operand(valid, m, queries.device)
    if queries.device.type == "cpu":
        return pairwise_scores_ref(queries, database, valid, metric)
    out = torch.empty((q, m), dtype=torch.float32, device=queries.device)
    if q * m == 0:
        return out
    lib = load_library()
    rc = lib.pairwise_scores_launch(
        queries.data_ptr(), database.data_ptr(), _ptr(valid), valid_bytes,
        out.data_ptr(), q, m, queries.shape[1], _METRIC_CODE[metric],
        stream_of(queries))
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


def _topk_outputs(q: int, m: int, k: int, device, chunks: int):
    """(out_ids, out_scores, part_s, part_m) for a top-k launch in
    ``chunks`` chunks; the partial lists are scratch for the chunks' merge
    (absent at 1 chunk)."""
    kk = min(k, m)
    out_ids, out_s = (torch.empty((q, k), dtype=dt, device=device)
                      for dt in (torch.int32, torch.float32))
    part_s = part_m = None
    if chunks > 1:
        part_s = torch.empty((q, chunks, kk), dtype=torch.float32,
                             device=device)
        part_m = torch.empty((q, chunks, kk), dtype=torch.int32,
                             device=device)
    return out_ids, out_s, part_s, part_m


def scored_topk(queries: torch.Tensor, database: torch.Tensor,
                valid: torch.Tensor | None, k: int, *, metric: str = "l2",
                fused: bool | None = None, chunks: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of ``queries`` [Q, K] against a shared ``database``
    [M, K]: exactly ``masked_topk(pairwise_scores(...), None, k)``, returned
    as ``(ids [Q, k] int32, scores [Q, k] f32)``.  ``fused=None`` resolves
    through :func:`fused_topk_enabled`; ``chunks`` overrides the registry's
    chunk count (the result does not depend on it)."""
    _check_metric(metric)
    k = _check_k(k)
    _check_queries(queries, database, "database")
    check_tensor(database, "database", torch.float32, 2)
    q, m = queries.shape[0], database.shape[0]
    valid, valid_bytes = _valid_operand(valid, m, queries.device)
    if fused is None:
        fused = fused_topk_enabled(queries.device)
    if not _fused_route(fused, k, m):
        return masked_topk(pairwise_scores(queries, database, valid,
                                           metric=metric), None, k)
    if queries.device.type == "cpu":
        return scored_topk_ref(queries, database, valid, k, metric)
    if q == 0 or m == 0:
        return _empty_topk(q, k, queries.device)
    chunks = _launch_chunks("scored_topk", (queries, database, valid, k),
                            {"metric": metric, "fused": fused}, chunks)
    out_ids, out_s, part_s, part_m = _topk_outputs(q, m, k, queries.device,
                                                   chunks)
    lib = load_library()
    rc = lib.scored_topk_launch(
        queries.data_ptr(), database.data_ptr(), _ptr(valid), valid_bytes,
        _ptr(part_s), _ptr(part_m), out_s.data_ptr(), out_ids.data_ptr(), q,
        m, queries.shape[1], _METRIC_CODE[metric], k, chunks,
        stream_of(queries))
    check_launch(lib, rc, "scored_topk")
    scored_topk.launches += 1
    return out_ids, out_s


scored_topk.launches = 0


def scored_topk_gathered(queries: torch.Tensor, cand: torch.Tensor,
                         mask: torch.Tensor, ids: torch.Tensor, k: int, *,
                         metric: str = "l2", fused: bool | None = None,
                         chunks: int | None = None
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
    chunks = _launch_chunks("scored_topk_gathered",
                            (queries, cand, mask, ids, k),
                            {"metric": metric, "fused": fused}, chunks)
    out_ids, out_s, part_s, part_m = _topk_outputs(q, m, k, queries.device,
                                                   chunks)
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


__all__ = ["METRICS", "NEG_INF", "MAX_TOPK", "PAIRWISE_KERNEL",
           "GATHERED_KERNEL", "chunks_key", "resolve_chunks",
           "chunk_candidates", "measured_chunks_search", "fused_topk_enabled",
           "pairwise_scores", "gathered_scores", "scored_topk",
           "scored_topk_gathered", "masked_topk"]
