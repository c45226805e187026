"""Plan/executor layer: prepare a graph once, embed it many times (port of
``repro/core/plan.py``).

  ``PreparedGraph``  an immutable wrapper over an ``EdgeList`` (on one
                     device) that lazily computes and memoizes every derived
                     artifact: self-loop augmentation, degrees, the
                     Laplacian fold, the ELL packings, the host arrays.
  ``GEEPlan``        resolves ``backend="auto"`` into explicit stages --
                     prep, compute, epilogue -- and executes them against a
                     labels vector.
  ``select_backend`` the cost model behind ``backend="auto"``: ``chunked``
                     when the working-set estimate exceeds the memory
                     budget, else the ``cuda`` kernels for a graph on the
                     card and ``sparse_torch`` on the CPU.
  ``sweep_options``  the many-settings path: correlation is a pure row
                     postprocess, so the 8 option settings need only 4
                     scatter passes over shared prep.

Backends ported so far: ``sparse_torch``, ``cuda``, ``chunked``,
``dense_torch``, ``scipy`` and ``python_loop``.  The reference's
multi-device backends (``streamed_sharded``, ``distributed``) are not yet
ported and raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import epilogue
from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions,
                                  gee_dense_torch, gee_python_loop,
                                  gee_scipy, gee_sparse_torch,
                                  laplacian_edge_weights)
from repro_torch.graph.containers import (EdgeList, add_self_loops, degrees,
                                          edge_list_from_numpy, symmetrize)
from repro_torch.kernels.gee_fused import MAX_CLASSES

KNOWN_BACKENDS = ("sparse_torch", "cuda", "chunked", "dense_torch", "scipy",
                  "python_loop")

# Working-set budget for the cost model's route to ``chunked`` (the
# reference's variable and default).
ENV_MEMORY_BUDGET = "REPRO_GEE_MEMORY_BUDGET_BYTES"
DEFAULT_MEMORY_BUDGET = 16 << 30


def _chunk_key(chunk_edges: int | None) -> int:
    """The ``("chunked", ...)`` cache-key component for a window size."""
    from repro_torch.graph.io import DEFAULT_CHUNK_EDGES

    return int(chunk_edges or DEFAULT_CHUNK_EDGES)


# ---------------------------------------------------------------------------
# PreparedGraph: the memoized prep artifacts
# ---------------------------------------------------------------------------

class PreparedGraph:
    """Immutable wrapper over an ``EdgeList`` memoizing derived artifacts.

    Artifacts (all lazy, each computed at most once per instance), on the
    edge list's device:

      * ``with_self_loops()``          the diag-aug edge list (A + I)
      * ``degrees(diag_aug)``          weighted degrees of the (augmented)
                                       graph
      * ``laplacian_inv_sqrt(diag)``   their clamped d^{-1/2}
      * ``effective_edges(opts)``      self-loop-augmented and
                                       Laplacian-folded edges, keyed on
                                       ``(diag_aug, laplacian)``
      * ``ell(diag_aug)`` /
        ``bucketed_ell(diag_aug)``     the kernels' packings (host O(E))
      * ``chunked(chunk_edges)``       the streaming backend's window
                                       manifest (slices on the device)
      * ``host_arrays()``              the valid-prefix numpy triple the
                                       SciPy / python-loop backends consume
    """

    def __init__(self, edges: EdgeList):
        if isinstance(edges, PreparedGraph):
            raise TypeError("already a PreparedGraph; use PreparedGraph.wrap")
        if not isinstance(edges, EdgeList):
            raise TypeError(f"expected an EdgeList, got "
                            f"{type(edges).__name__}")
        self._edges = edges
        self._cache: Dict[tuple, object] = {}
        self._hits = 0
        self._misses = 0

    # -- construction --------------------------------------------------------
    @staticmethod
    def wrap(graph: "PreparedGraph | EdgeList") -> "PreparedGraph":
        """Idempotent constructor: wrap an ``EdgeList``, pass a
        ``PreparedGraph`` through untouched (preserving its caches)."""
        return graph if isinstance(graph, PreparedGraph) \
            else PreparedGraph(graph)

    @staticmethod
    def from_arrays(src, dst, weight=None, num_nodes: int | None = None,
                    undirected: bool = True, pad_to: int | None = None,
                    device=None) -> "PreparedGraph":
        """Build from raw host arrays on ``device`` (``None``: the card):
        symmetrize (for undirected input) and upload exactly once."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        n = int(num_nodes if num_nodes is not None
                else max(int(src.max(initial=-1)),
                         int(dst.max(initial=-1))) + 1)
        edges = edge_list_from_numpy(
            src, dst, None if weight is None else np.asarray(weight), n,
            pad_to=pad_to, device=resolve_device(device))
        if undirected:
            edges = symmetrize(edges)
        return PreparedGraph(edges)

    # -- basics --------------------------------------------------------------
    @property
    def base(self) -> EdgeList:
        """The wrapped (already-directed) edge list."""
        return self._edges

    @property
    def device(self) -> torch.device:
        return self._edges.device

    @property
    def num_nodes(self) -> int:
        return self._edges.num_nodes

    @property
    def num_edges(self) -> int:
        return self._edges.num_edges

    def _memo(self, key: tuple, build):
        hit = self._cache.get(key)
        if hit is not None:
            self._hits += 1
            return hit
        self._misses += 1
        value = build()
        self._cache[key] = value
        return value

    def is_cached(self, key: tuple) -> bool:
        return key in self._cache

    def cache_info(self) -> dict:
        """Which artifacts are resident, plus hit/miss counters."""
        return {"keys": tuple(sorted(map(str, self._cache))),
                "entries": len(self._cache),
                "hits": self._hits, "misses": self._misses}

    # -- prep artifacts ------------------------------------------------------
    def with_self_loops(self) -> EdgeList:
        """The diagonal-augmented list (A + I)."""
        return self._memo(("self_loops",),
                          lambda: add_self_loops(self._edges))

    def augmented(self, diag_aug: bool) -> EdgeList:
        return self.with_self_loops() if diag_aug else self._edges

    def degrees(self, diag_aug: bool = False) -> torch.Tensor:
        """Weighted out-degrees of the (augmented) graph, [N] f32."""
        return self._memo(("degrees", bool(diag_aug)),
                          lambda: degrees(self.augmented(diag_aug)))

    def laplacian_inv_sqrt(self, diag_aug: bool = False) -> torch.Tensor:
        """d^{-1/2} of the (augmented) degrees, shared-epilogue clamped."""
        return self._memo(
            ("dinv", bool(diag_aug)),
            lambda: epilogue.inv_sqrt_degrees(self.degrees(diag_aug)))

    def effective_edges(self, opts: GEEOptions) -> EdgeList:
        """The scatter stage's exact input: self loops appended when
        ``opts.diag_aug``, weights Laplacian-folded when ``opts.laplacian``
        (degrees of the *augmented* graph).  Correlation never affects
        prep."""
        key = ("eff", bool(opts.diag_aug), bool(opts.laplacian))

        def build():
            e = self.augmented(opts.diag_aug)
            if not opts.laplacian:
                return e
            return dataclasses.replace(e, weight=laplacian_edge_weights(e))
        return self._memo(key, build)

    def ell(self, diag_aug: bool = False):
        """Single-plane ELL packing of the (augmented) graph."""
        from repro_torch.graph.ell import edges_to_ell

        return self._memo(("ell", bool(diag_aug)),
                          lambda: edges_to_ell(self.augmented(diag_aug)))

    def bucketed_ell(self, diag_aug: bool = False):
        """Degree-bucketed ELL packing of the (augmented) graph."""
        from repro_torch.graph.ell import edges_to_bucketed_ell

        return self._memo(
            ("bucketed_ell", bool(diag_aug)),
            lambda: edges_to_bucketed_ell(self.augmented(diag_aug)))

    def chunked(self, chunk_edges: int | None = None):
        """The streaming backend's window manifest over the valid prefix,
        on the edge list's device (one manifest per window size)."""
        from repro_torch.graph.io import ChunkedEdgeList

        chunk = _chunk_key(chunk_edges)
        return self._memo(
            ("chunked", chunk),
            lambda: ChunkedEdgeList.from_edge_list(self._edges, chunk))

    def host_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Valid-prefix ``(src, dst, weight)`` numpy triple."""
        return self._memo(("host",), self._edges.valid_arrays)


# ---------------------------------------------------------------------------
# the cost model behind backend="auto"
# ---------------------------------------------------------------------------

def _bucketed_slot_estimate(edges: EdgeList) -> int:
    """Total ELL slots after degree-bucketed packing of the augmented graph
    (host O(E) bincount on the packer's own width ladder)."""
    from repro_torch.graph.ell import bucket_widths

    src, _, w = edges.valid_arrays()
    deg = np.bincount(src[w != 0], minlength=edges.num_nodes) + 1  # + loop
    widths = np.asarray(bucket_widths(int(deg.max(initial=1))))
    return int(widths[np.searchsorted(widths, deg)].sum())


def estimate_working_set_bytes(graph: PreparedGraph | EdgeList,
                               num_classes: int, *,
                               backend: str = "sparse_torch") -> int:
    """Rough in-memory working set of the in-memory backends.

    ``sparse_torch`` counts base + effective edge triples (self loops
    included), the degree vector and Z.  ``cuda`` counts the post-packing
    ELL slots instead: cols + vals + the ylab/contrib planes are 16 bytes a
    slot, and on skewed degree distributions slots >> E.
    """
    edges = graph.base if isinstance(graph, PreparedGraph) else graph
    n = edges.num_nodes
    base_bytes = 3 * 4 * edges.padded_size
    z_deg_bytes = 4 * n + 4 * n * int(num_classes)
    if backend == "cuda":
        if isinstance(graph, PreparedGraph):
            slots = graph._memo(("ell_slots",),
                                lambda: _bucketed_slot_estimate(edges))
        else:
            slots = _bucketed_slot_estimate(edges)
        return base_bytes + 16 * slots + z_deg_bytes
    e_eff = edges.padded_size + n                    # with self loops
    return base_bytes + 3 * 4 * e_eff + z_deg_bytes


def memory_budget_bytes() -> int:
    """The route-to-chunked threshold: ``REPRO_GEE_MEMORY_BUDGET_BYTES`` or
    a 16 GiB default."""
    return int(os.environ.get(ENV_MEMORY_BUDGET, DEFAULT_MEMORY_BUDGET))


def select_backend(graph: PreparedGraph | EdgeList, num_classes: int, *,
                   device=None, budget_bytes: int | None = None) -> str:
    """The ``backend="auto"`` cost model.

    1. If the estimated working set exceeds the memory budget, stream:
       ``chunked``, whose device memory is O(window + N*K) whatever E is
       (the reference's multi-device alternative is not yet ported).
    2. ``cuda`` (the hand-written kernels) for a graph on the card,
       whatever K: past the fused kernel's cap (``MAX_CLASSES``)
       ``select_fused`` keeps the plan on the staged kernels.
    3. ``sparse_torch`` on the CPU.

    ``device=None`` reads the graph's device; ``budget_bytes=None`` reads
    :func:`memory_budget_bytes`.
    """
    edges = graph.base if isinstance(graph, PreparedGraph) else graph
    budget = memory_budget_bytes() if budget_bytes is None else budget_bytes
    if estimate_working_set_bytes(graph, num_classes) > budget:
        return "chunked"
    dev = torch.device(device).type if device is not None \
        else edges.device.type
    return "cuda" if dev == "cuda" else "sparse_torch"


def select_fused(backend: str, opts: GEEOptions, *, device=None,
                 num_classes: int = 1) -> bool:
    """The fused-epilogue stage's cost model (``fused="auto"``).

    The fused kernel replaces the staged scatter + epilogue of the ``cuda``
    backend; it pays off when there is an epilogue to fuse (diag-aug or
    correlation) and the kernels run on the card.  ``REPRO_GEE_FUSED=1/0``
    overrides everything but the backend and the fused kernel's cap on K
    (``MAX_CLASSES``, set by its shared memory).  ``device=None`` means the
    card.
    """
    if backend != "cuda" or num_classes > MAX_CLASSES:
        return False
    from repro_torch.kernels.gee_fused import fused_override

    override = fused_override()
    if override is not None:
        return bool(override)
    dev = "cuda" if device is None else torch.device(device).type
    return dev == "cuda" and bool(opts.diag_aug or opts.correlation)


# ---------------------------------------------------------------------------
# GEEPlan: resolved stages + executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanStage:
    """One resolved execution stage (introspection surface)."""

    kind: str            # "prep" | "compute" | "epilogue"
    name: str
    cached: bool = False  # artifact already resident in the PreparedGraph
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class GEEPlan:
    """An executable embedding plan: resolved backend + staged pipeline,
    on the prepared graph's device."""

    prepared: PreparedGraph
    num_classes: int
    opts: GEEOptions
    backend: str                      # resolved; never "auto"
    fused: bool = False               # cuda only: the fused-epilogue kernel
    chunk_edges: Optional[int] = None  # chunked only: the window size
    # chunked only: windows staged ahead by background threads (resolved by
    # build(); None for the in-memory backends)
    prefetch_windows: Optional[int] = None

    @staticmethod
    def build(graph: PreparedGraph | EdgeList, num_classes: int,
              opts: GEEOptions = GEEOptions(), *, backend: str = "auto",
              fused: "bool | str" = "auto", chunk_edges: int | None = None,
              budget_bytes: int | None = None,
              prefetch_windows: int | None = None) -> "GEEPlan":
        prepared = PreparedGraph.wrap(graph)
        if backend == "auto":
            backend = select_backend(prepared, num_classes,
                                     budget_bytes=budget_bytes)
        if backend not in KNOWN_BACKENDS:
            raise ValueError(
                f"backend {backend!r} is not yet ported to repro_torch; "
                f"known: {KNOWN_BACKENDS} (+ 'auto')")
        if fused == "auto":
            fused = select_fused(backend, opts, device=prepared.device,
                                 num_classes=num_classes)
        if backend == "chunked":
            from repro_torch.graph.prefetch import resolve_prefetch_depth

            prefetch_windows = resolve_prefetch_depth(prefetch_windows)
        else:
            prefetch_windows = None      # the knob exists for streaming only
        return GEEPlan(prepared=prepared, num_classes=int(num_classes),
                       opts=opts, backend=backend,
                       fused=bool(fused) and backend == "cuda",
                       chunk_edges=chunk_edges,
                       prefetch_windows=prefetch_windows)

    # -- introspection -------------------------------------------------------
    @property
    def stages(self) -> Tuple[PlanStage, ...]:
        p, o = self.prepared, self.opts
        out = []
        if self.backend == "sparse_torch":
            out.append(PlanStage(
                "prep", "effective_edges",
                cached=p.is_cached(("eff", o.diag_aug, o.laplacian)),
                detail="self-loop augment + laplacian fold"))
            out.append(PlanStage("compute", "segment_scatter",
                                 detail="flat index_add_, O(E)"))
        elif self.backend == "cuda":
            # fused packs the *base* graph (diag-aug folds in as deg+1 +
            # the in-kernel addend); staged packs the augmented graph
            packed_aug = o.diag_aug and not self.fused
            out.append(PlanStage(
                "prep", "bucketed_ell",
                cached=p.is_cached(("bucketed_ell", packed_aug)),
                detail="degree-bucketed ELL packing (host, O(E))"))
            if self.fused:
                out.append(PlanStage(
                    "compute", "gee_spmm_fused",
                    detail="contraction + diag-aug + row-norm, one kernel"))
            else:
                out.append(PlanStage(
                    "compute", "gee_spmm",
                    detail="row-parallel class contraction per bucket"))
        elif self.backend == "chunked":
            chunk = _chunk_key(self.chunk_edges)
            out.append(PlanStage("prep", "chunk_manifest",
                                 cached=p.is_cached(("chunked", chunk)),
                                 detail=f"window={chunk} edges, "
                                        f"prefetch={self.prefetch_windows}"))
            out.append(PlanStage("compute", "two_pass_stream",
                                 detail="degree fold + per-class fold"))
        elif self.backend == "dense_torch":
            out.append(PlanStage("compute", "dense_matmul",
                                 detail="A @ W oracle, O(N^2)"))
        else:                          # scipy / python_loop host references
            out.append(PlanStage("prep", "host_arrays",
                                 cached=p.is_cached(("host",)),
                                 detail="valid-prefix numpy triple"))
            out.append(PlanStage("compute", self.backend))
        if o.correlation and not self.fused \
                and self.backend in ("sparse_torch", "cuda"):
            out.append(PlanStage("epilogue", "row_l2_normalize",
                                 detail="row_norm kernel on the card"))
        return tuple(out)

    def describe(self) -> str:
        """One line per stage."""
        head = (f"GEEPlan(backend={self.backend}"
                + (", fused" if self.fused else "")
                + f", opts={self.opts.tag()}, "
                f"N={self.prepared.num_nodes}, "
                f"E={self.prepared.num_edges}, K={self.num_classes}, "
                f"device={self.prepared.device})")
        lines = [head]
        for s in self.stages:
            lines.append(f"  [{s.kind:8s}] {s.name}"
                         + (" (cached)" if s.cached else "")
                         + (f" -- {s.detail}" if s.detail else ""))
        return "\n".join(lines)

    # -- execution -----------------------------------------------------------
    def execute(self, labels) -> torch.Tensor:
        """Run the staged pipeline for one labels vector; returns [N, K]
        f32 on the prepared graph's device."""
        k, o, p = self.num_classes, self.opts, self.prepared
        if self.backend in ("scipy", "python_loop"):
            src, dst, w = p.host_arrays()
            y = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
                 else np.asarray(labels))
            fn = gee_scipy if self.backend == "scipy" else gee_python_loop
            z = fn(src, dst, w, y, k, o, num_nodes=p.num_nodes)
            return torch.from_numpy(np.ascontiguousarray(z)).to(p.device)
        if self.backend == "chunked":
            from repro_torch.core.chunked import gee_chunked

            return gee_chunked(p.chunked(self.chunk_edges), labels, k, o,
                               prefetch_windows=self.prefetch_windows,
                               device=p.device)
        if self.backend == "dense_torch":
            return gee_dense_torch(p.base, labels, k, o)
        labels = torch.as_tensor(labels).to(device=p.device,
                                            dtype=torch.int32)
        if self.backend == "sparse_torch":
            # prep already applied: the scatter runs with bare options
            z = gee_sparse_torch(p.effective_edges(o), labels, k,
                                 GEEOptions())
        elif self.fused:
            from repro_torch.kernels.gee_fused import gee_fused_from_bucketed

            # base-graph packing: diag-aug folds in as deg+1 + the in-kernel
            # addend, so the augmented packing is never built
            return gee_fused_from_bucketed(p.bucketed_ell(False), labels, k,
                                           o)
        else:
            from repro_torch.kernels.ops import gee_cuda_from_bucketed

            z = gee_cuda_from_bucketed(
                p.bucketed_ell(o.diag_aug), labels, k,
                GEEOptions(laplacian=o.laplacian))
        if o.correlation:
            z = epilogue.row_l2_normalize(z.contiguous())
        return z


# ---------------------------------------------------------------------------
# the many-settings path (ensemble / comparison sweeps)
# ---------------------------------------------------------------------------

def sweep_options(graph: PreparedGraph | EdgeList, labels, num_classes: int,
                  settings: Iterable[GEEOptions] = ALL_OPTION_SETTINGS, *,
                  backend: str = "sparse_torch",
                  chunk_edges: int | None = None) -> Mapping[GEEOptions, torch.Tensor]:
    """Embed one graph under many option settings with all prep shared;
    settings that differ only in correlation share one scatter pass.
    Returns ``{opts: Z}`` in the order given."""
    prepared = PreparedGraph.wrap(graph)
    raw: Dict[Tuple[bool, bool], torch.Tensor] = {}
    out: Dict[GEEOptions, torch.Tensor] = {}
    for opts in settings:
        key = (bool(opts.laplacian), bool(opts.diag_aug))
        if key not in raw:
            base = GEEOptions(laplacian=opts.laplacian,
                              diag_aug=opts.diag_aug)
            raw[key] = GEEPlan.build(
                prepared, num_classes, base, backend=backend,
                chunk_edges=chunk_edges).execute(labels)
        z = raw[key]
        if opts.correlation:
            z = epilogue.row_l2_normalize(z.contiguous())
        out[opts] = z
    return out


__all__ = ["PreparedGraph", "GEEPlan", "PlanStage", "select_backend",
           "select_fused", "sweep_options", "estimate_working_set_bytes",
           "memory_budget_bytes", "KNOWN_BACKENDS", "ENV_MEMORY_BUDGET",
           "DEFAULT_MEMORY_BUDGET"]
