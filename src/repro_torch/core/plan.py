"""Plan/executor layer: prepare a graph once, embed it many times (port of
``repro/core/plan.py``).

  ``PreparedGraph``  an immutable wrapper over an ``EdgeList`` (on one
                     device) that lazily computes and memoizes every derived
                     artifact: self-loop augmentation, degrees, the
                     Laplacian fold, the ELL packings, the host arrays.
  ``GEEPlan``        resolves ``backend="auto"`` into explicit stages --
                     prep, compute, epilogue -- and executes them against a
                     labels vector.
  ``select_backend`` the cost model behind ``backend="auto"``: past the
                     memory budget ``streamed_sharded`` across the ranks
                     of a process group, or ``chunked`` on one device;
                     else the ``cuda`` kernels for a graph on the card and
                     ``sparse_torch`` on the CPU.
  ``sweep_options``  the many-settings path: correlation is a pure row
                     postprocess, so the 8 option settings need only 4
                     scatter passes over shared prep.

Backends: ``sparse_torch``, ``cuda``, ``chunked``, ``streamed_sharded``,
``distributed``, ``dense_torch``, ``scipy`` and ``python_loop``.  The two
multi-device backends run over a ``torch.distributed`` process group
(``group=None``: the default one, or a world of one) with a per-rank
``local_backend`` (``segment_sum`` or ``cuda``), and gather the ranks' row
blocks, so every backend returns the whole [N, K].  ``auto`` never picks
``distributed``, as in the reference: where the data lives is the caller's
choice.

With the global tracer on (``repro_torch.obs.trace``), ``execute`` runs
under a ``plan.execute`` root span with one ``plan.stage.<name>`` span a
stage, syncs the card at each stage's end so the spans time the device's
work, counts ``plan.executions`` / ``plan.cache_hits`` /
``plan.cache_misses``, records the ``plan.execute_ms`` histogram and keeps
the stage times for ``describe(timings=True)``.  Untraced, a stage is a
plain call with no sync.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import epilogue
from repro_torch.core.fold import LOCAL_BACKENDS, gather_rows, world_size
from repro_torch.core.gee import (ALL_OPTION_SETTINGS, GEEOptions,
                                  gee_dense_torch, gee_python_loop,
                                  gee_scipy, gee_sparse_torch,
                                  laplacian_edge_weights)
from repro_torch.graph.containers import (EdgeList, add_self_loops, degrees,
                                          edge_list_from_numpy, symmetrize)
from repro_torch.kernels.gee_fused import MAX_CLASSES
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

KNOWN_BACKENDS = ("sparse_torch", "cuda", "chunked", "streamed_sharded",
                  "distributed", "dense_torch", "scipy", "python_loop")
STREAMING_BACKENDS = ("chunked", "streamed_sharded")

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
                   device=None, budget_bytes: int | None = None,
                   num_devices: int | None = None) -> str:
    """The ``backend="auto"`` cost model.

    1. If the estimated working set exceeds the memory budget, stream:
       ``streamed_sharded`` when more than one rank can fold disjoint
       sub-windows in parallel, ``chunked`` on one device; either way
       device memory is O(window + N*K) whatever E is.
    2. ``cuda`` (the hand-written kernels) for a graph on the card,
       whatever K: past the fused kernel's cap (``MAX_CLASSES``)
       ``select_fused`` keeps the plan on the staged kernels.
    3. ``sparse_torch`` on the CPU.

    ``auto`` never picks ``distributed``.  ``device=None`` reads the
    graph's device; ``budget_bytes=None`` reads :func:`memory_budget_bytes`;
    ``num_devices=None`` is the default process group's world size (1 when
    none is initialized): under SPMD the ranks are the devices.
    """
    edges = graph.base if isinstance(graph, PreparedGraph) else graph
    budget = memory_budget_bytes() if budget_bytes is None else budget_bytes
    if estimate_working_set_bytes(graph, num_classes) > budget:
        if num_devices is None:
            num_devices = world_size()
        return "streamed_sharded" if num_devices > 1 else "chunked"
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
    # the streaming backends' window size
    chunk_edges: Optional[int] = None
    # streaming backends only: windows staged ahead by background threads
    # (resolved by build(); None for the in-memory backends)
    prefetch_windows: Optional[int] = None
    # multi-device backends only: each rank's compute and the process group
    local_backend: str = "segment_sum"
    group: object = dataclasses.field(default=None, compare=False)
    # per-stage wall times (ms) of the last *traced* execution; a mutable
    # cell on a frozen plan, excluded from eq/repr, never reassigned
    _timings: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    @staticmethod
    def build(graph: PreparedGraph | EdgeList, num_classes: int,
              opts: GEEOptions = GEEOptions(), *, backend: str = "auto",
              fused: "bool | str" = "auto", chunk_edges: int | None = None,
              budget_bytes: int | None = None,
              prefetch_windows: int | None = None,
              local_backend: str = "segment_sum",
              group=None) -> "GEEPlan":
        prepared = PreparedGraph.wrap(graph)
        if backend == "auto":
            backend = select_backend(prepared, num_classes,
                                     budget_bytes=budget_bytes,
                                     num_devices=world_size(group))
        if backend not in KNOWN_BACKENDS:
            raise ValueError(
                f"backend {backend!r} is not one of repro_torch's: "
                f"{KNOWN_BACKENDS} (+ 'auto')")
        if local_backend not in LOCAL_BACKENDS:
            raise ValueError(f"unknown local_backend {local_backend!r}; "
                             f"pick one of {LOCAL_BACKENDS}")
        if fused == "auto":
            fused = select_fused(backend, opts, device=prepared.device,
                                 num_classes=num_classes)
        if backend in STREAMING_BACKENDS:
            from repro_torch.graph.prefetch import resolve_prefetch_depth

            prefetch_windows = resolve_prefetch_depth(prefetch_windows)
        else:
            prefetch_windows = None      # the knob exists for streaming only
        return GEEPlan(prepared=prepared, num_classes=int(num_classes),
                       opts=opts, backend=backend,
                       fused=bool(fused) and backend == "cuda",
                       chunk_edges=chunk_edges,
                       prefetch_windows=prefetch_windows,
                       local_backend=local_backend, group=group)

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
        elif self.backend in STREAMING_BACKENDS:
            chunk = _chunk_key(self.chunk_edges)
            split = ", split across ranks" \
                if self.backend == "streamed_sharded" else ""
            out.append(PlanStage("prep", "chunk_manifest",
                                 cached=p.is_cached(("chunked", chunk)),
                                 detail=f"window={chunk} edges, "
                                        f"prefetch={self.prefetch_windows}"
                                        + split))
            if self.backend == "chunked":
                out.append(PlanStage("compute", "two_pass_stream",
                                     detail="degree fold + per-class fold"))
            else:
                out.append(PlanStage(
                    "compute", "window_shard_fold",
                    detail=f"per-rank sub-window fold "
                           f"({self.local_backend}), reduce_scatter + "
                           f"row-local epilogue"))
        elif self.backend == "distributed":
            out.append(PlanStage(
                "compute", "edge_shard_fold",
                detail=f"host edge shard, per-rank {self.local_backend}, "
                       f"reduce_scatter + row-local epilogue"))
        elif self.backend == "dense_torch":
            out.append(PlanStage("compute", "dense_matmul",
                                 detail="A @ W oracle, O(N^2)"))
        else:                          # scipy / python_loop host references
            out.append(PlanStage("prep", "host_arrays",
                                 cached=p.is_cached(("host",)),
                                 detail="valid-prefix numpy triple"))
            out.append(PlanStage("compute", self.backend))
        if self.backend in ("streamed_sharded", "distributed"):
            out.append(PlanStage("epilogue", "gather_rows",
                                 detail="all_gather of the ranks' row "
                                        "blocks"))
        if o.correlation and not self.fused \
                and self.backend in ("sparse_torch", "cuda"):
            out.append(PlanStage("epilogue", "row_l2_normalize",
                                 detail="row_norm kernel on the card"))
        return tuple(out)

    def describe(self, timings: bool = False) -> str:
        """One line per stage.

        ``timings=True`` adds each stage's wall time from the last *traced*
        execution (run :meth:`execute` with the tracer enabled first:
        untraced executions skip the stage-end syncs that make the times
        honest, so they record nothing).
        """
        head = (f"GEEPlan(backend={self.backend}"
                + (", fused" if self.fused else "")
                + f", opts={self.opts.tag()}, "
                f"N={self.prepared.num_nodes}, "
                f"E={self.prepared.num_edges}, K={self.num_classes}, "
                f"device={self.prepared.device})")
        timed = self._timings if timings else {}
        lines = [head]
        for s in self.stages:
            line = (f"  [{s.kind:8s}] {s.name}"
                    + (" (cached)" if s.cached else "")
                    + (f" -- {s.detail}" if s.detail else ""))
            if s.name in timed:
                line += f"  [{timed[s.name]:.2f} ms]"
            lines.append(line)
        if timings:
            if "total_ms" in timed:
                lines.append(f"  total {timed['total_ms']:.2f} ms "
                             f"(stage syncs forced by tracing)")
            else:
                lines.append("  (no traced execution yet: enable the "
                             "tracer, then execute())")
        return "\n".join(lines)

    @property
    def last_timings(self) -> dict:
        """``{stage_name: ms, "total_ms": ms}`` from the last traced
        execution (empty until one happens)."""
        return dict(self._timings)

    # -- execution -----------------------------------------------------------
    def _sync(self) -> None:
        if self.prepared.device.type == "cuda":
            torch.cuda.synchronize(self.prepared.device)

    def _stage(self, kind: str, name: str, cached: bool, fn):
        """Run one stage under a ``plan.stage.<name>`` span.

        Untraced this is a plain call.  Traced, the card is synced before
        the span closes: launches are asynchronous, so without the sync a
        stage would bill its device time to whoever waits next.
        """
        tr = obs_trace.get_tracer()
        if not tr.enabled:
            return fn()
        t0 = time.perf_counter()
        with tr.span("plan.stage." + name, kind=kind, cached=cached):
            out = fn()
            self._sync()
        self._timings[name] = (time.perf_counter() - t0) * 1e3
        return out

    def execute(self, labels) -> torch.Tensor:
        """Run the staged pipeline for one labels vector; returns [N, K]
        f32 on the prepared graph's device.

        With the global tracer enabled, the stages run under one
        ``plan.execute`` root span tagged with the prep cache's hits and
        misses, and their times are kept for
        :meth:`describe(timings=True) <describe>`.
        """
        tr = obs_trace.get_tracer()
        if not tr.enabled:
            return self._execute_stages(labels)
        self._timings.clear()
        p = self.prepared
        hits0, misses0 = p._hits, p._misses
        t0 = time.perf_counter()
        with tr.span("plan.execute", backend=self.backend,
                     n=p.num_nodes, e=p.num_edges, k=self.num_classes,
                     opts=self.opts.tag(), fused=self.fused) as root:
            z = self._execute_stages(labels)
            self._sync()
            root.tag(cache_hits=p._hits - hits0,
                     cache_misses=p._misses - misses0)
        total_ms = (time.perf_counter() - t0) * 1e3
        self._timings["total_ms"] = total_ms
        reg = obs_metrics.get_registry()
        reg.counter("plan.executions").inc()
        reg.counter("plan.cache_hits").inc(p._hits - hits0)
        reg.counter("plan.cache_misses").inc(p._misses - misses0)
        reg.histogram("plan.execute_ms").observe(total_ms)
        return z

    def _execute_stages(self, labels) -> torch.Tensor:
        k, o, p = self.num_classes, self.opts, self.prepared
        if self.backend in ("scipy", "python_loop"):
            src, dst, w = self._stage("prep", "host_arrays",
                                      p.is_cached(("host",)), p.host_arrays)
            y = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
                 else np.asarray(labels))
            fn = gee_scipy if self.backend == "scipy" else gee_python_loop
            return self._stage(
                "compute", self.backend, False,
                lambda: torch.from_numpy(np.ascontiguousarray(
                    fn(src, dst, w, y, k, o, num_nodes=p.num_nodes)))
                .to(p.device))
        if self.backend in STREAMING_BACKENDS:
            chunk = self.chunk_edges
            manifest = self._stage(
                "prep", "chunk_manifest",
                p.is_cached(("chunked", _chunk_key(chunk))),
                lambda: p.chunked(chunk))
            if self.backend == "chunked":
                from repro_torch.core.chunked import gee_chunked

                return self._stage(
                    "compute", "two_pass_stream", False,
                    lambda: gee_chunked(
                        manifest, labels, k, o,
                        prefetch_windows=self.prefetch_windows,
                        device=p.device))
            from repro_torch.core.fold import gee_streamed_sharded

            z = self._stage(
                "compute", "window_shard_fold", False,
                lambda: gee_streamed_sharded(
                    manifest, labels, k, o, group=self.group,
                    local_backend=self.local_backend,
                    prefetch_windows=self.prefetch_windows,
                    device=p.device))
            return self._gather(z)
        if self.backend == "distributed":
            from repro_torch.core.distributed import gee_distributed

            z = self._stage(
                "compute", "edge_shard_fold", False,
                lambda: gee_distributed(
                    p, labels, k, o, group=self.group,
                    local_backend=self.local_backend))
            return self._gather(z)
        if self.backend == "dense_torch":
            return self._stage(
                "compute", "dense_matmul", False,
                lambda: gee_dense_torch(p.base, labels, k, o))
        labels = torch.as_tensor(labels).to(device=p.device,
                                            dtype=torch.int32)
        if self.backend == "sparse_torch":
            eff = self._stage(
                "prep", "effective_edges",
                p.is_cached(("eff", o.diag_aug, o.laplacian)),
                lambda: p.effective_edges(o))
            # prep already applied: the scatter runs with bare options
            z = self._stage(
                "compute", "segment_scatter", False,
                lambda: gee_sparse_torch(eff, labels, k, GEEOptions()))
        elif self.fused:
            from repro_torch.kernels.gee_fused import gee_fused_from_bucketed

            # base-graph packing: diag-aug folds in as deg+1 + the in-kernel
            # addend, so the augmented packing is never built
            bell = self._stage(
                "prep", "bucketed_ell",
                p.is_cached(("bucketed_ell", False)),
                lambda: p.bucketed_ell(False))
            return self._stage(
                "compute", "gee_spmm_fused", False,
                lambda: gee_fused_from_bucketed(bell, labels, k, o))
        else:
            from repro_torch.kernels.ops import gee_cuda_from_bucketed

            bell = self._stage(
                "prep", "bucketed_ell",
                p.is_cached(("bucketed_ell", o.diag_aug)),
                lambda: p.bucketed_ell(o.diag_aug))
            z = self._stage(
                "compute", "gee_spmm", False,
                lambda: gee_cuda_from_bucketed(
                    bell, labels, k, GEEOptions(laplacian=o.laplacian)))
        if o.correlation:
            z = self._stage(
                "epilogue", "row_l2_normalize", False,
                lambda: epilogue.row_l2_normalize(z.contiguous()))
        return z

    def _gather(self, z_block: torch.Tensor) -> torch.Tensor:
        """The multi-device backends' last stage: every rank's row block,
        assembled into [N, K]."""
        return self._stage(
            "epilogue", "gather_rows", False,
            lambda: gather_rows(z_block, self.prepared.num_nodes,
                                group=self.group))


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
