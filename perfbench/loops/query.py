"""Query traffic: a held-out query set handed to ``GEEQueryService`` over
the ``ClassPartitionedIndex`` of one fit, as ANN-Benchmarks' batch mode
hands its whole query set to an index.

Set-up draws the graph on the device and builds the kernels
(``graphs.prepare``), fits it cold with the true labels
(``GEEEmbedder.fit_transform``, packing on the host), builds the index
(``build_index``) and a ``GEEQueryService`` flushing every
``flush_every`` queries at the mix's ``k`` and ``nprobe`` (``null``: the
index's default), and warms it with flushes of the window's shape.

The query set is ``query_set`` distinct vertices drawn uniformly once
from the configuration's structure seed, in the graph's own numbering; the
run's seed renumbers them with the graph and orders them, so every seed
asks the same questions.  Each query is one vertex id, submitted as a
request of its own (``submit_rows``), one after another with no wait; the
service answers them in flushes of ``flush_every``.  The window cycles
the set, and the end of each pass flushes what is queued, as the end of a
batch.  A unit is one flush.  ``queries_per_s`` is the queries answered
over the window.

The check keeps every answer.  ``recall_at_10`` holds all of them against
the exact top-k over the same Z (the program's, brute force in plain
torch); the reference judges a seeded sample of whole flushes against
the float64 probe and top-k worked out again from the graph.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.api import GEEEmbedder
from repro_torch.core.gee import GEEOptions
from repro_torch.search.service import GEEQueryService

from perfbench import graphs, roofline
from perfbench.reference import gee as ref
from perfbench.reference import ivf

_EXACT_CHUNK = 2048
_RECALL_CHUNK = 1 << 20


def first_seen(ids: np.ndarray) -> np.ndarray:
    """[Q, k] bool: each id that no earlier position of its row holds."""
    keep = np.ones(ids.shape, bool)
    for j in range(1, ids.shape[1]):
        keep[:, j] = ~(ids[:, j:j + 1] == ids[:, :j]).any(axis=1)
    return keep


class Loop:
    units = "flushes"

    def __init__(self, cfg, traffic, seed, device, clock):
        self.traffic, self.seed = traffic, int(seed)
        self.device = torch.device(device)
        self.k_top = int(traffic["k"])

        graph = graphs.prepare(cfg, seed, self.device, clock)
        self.host = graph.host
        n, k = graph.n, graph.k
        self.n, self.k = n, k
        fixed = np.random.default_rng([int(cfg["structure_seed"]), 3])
        chosen = fixed.choice(n, size=min(int(traffic["query_set"]), n),
                              replace=False)
        order = np.random.default_rng([self.seed % (1 << 63), 3]).permutation(
            chosen.size)
        self.queries = self.host["perm"][chosen[order]].astype(np.int64)
        clock.phase("synthesis")

        self.options = tuple(bool(cfg["options"][f]) for f in
                             ("laplacian", "diag_aug", "correlation"))
        emb = GEEEmbedder(num_classes=k, options=GEEOptions(*self.options),
                          device=str(self.device))
        t0 = time.perf_counter()
        emb.fit_transform(graph.prepared, self.host["labels"]).cpu()
        self.cold_fit_ms = (time.perf_counter() - t0) * 1e3
        del graph
        clock.phase("cold_fit")
        t0 = time.perf_counter()
        index = emb.build_index()
        self._sync()
        self.index_build_ms = (time.perf_counter() - t0) * 1e3
        clock.phase("index_build")
        self.emb = emb
        self.service = GEEQueryService(
            index, flush_every=int(traffic["flush_every"]),
            nprobe=traffic["nprobe"], default_k=self.k_top)

        self.next_q = 0
        self._open = []
        self._reset_records()
        for _ in range(int(traffic["warmup_flushes"])):
            self.unit()
        self.finish()
        self._sync()
        self._reset_records()
        self.host_samples = {}
        clock.phase("warmup")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reset_records(self) -> None:
        """Every flush's answers, one entry a flush (nothing a query, so
        the window adds little for the collector to walk): the positions
        in the query set it answered, and the ids and scores served."""
        self.flushes = self.attempts = 0
        self.asked, self.ids, self.scores = [], [], []

    def _collect(self) -> None:
        self.asked.append(np.fromiter((p for _, p in self._open), np.int64,
                                      len(self._open)))
        self.ids.append(np.concatenate([t.ids for t, _ in self._open]))
        self.scores.append(np.concatenate([t.scores for t, _ in self._open]))
        self._open = []
        self.flushes += 1

    def unit(self) -> int:
        """Queries one at a time until a flush answers them."""
        while True:
            pos = self.next_q % self.queries.size
            self.next_q += 1
            self.attempts += 1
            ticket = self.service.submit_rows(self.queries[pos:pos + 1])
            self._open.append((ticket, pos))
            if not ticket.done and pos == self.queries.size - 1:
                self.service.flush()
            if ticket.done:
                self._collect()
                return 1

    def finish(self) -> None:
        if self._open:
            self.service.flush()
            self._collect()

    def answered(self) -> int:
        return sum(a.size for a in self.asked)

    def attempted(self) -> tuple:
        return self.attempts, self.attempts - self.answered()

    def end_to_end(self, seconds: float) -> dict:
        return {"queries_per_s": self.answered() / seconds,
                "recall_at_10": self.recall()}

    def recall(self) -> float:
        """Recall@k of every answer against the exact top-k over the same
        Z: an id counts where its exact score reaches the exact k-th best
        (within 1e-6 of the score scale, for ties), once a row however
        often it is served.  Plain torch in float64 on the index's
        device."""
        z = self.service.index.z.to(torch.float64)
        rows = self.queries[np.concatenate(self.asked)]
        ids = np.concatenate(self.ids).astype(np.int64)
        uniq, inv = np.unique(rows, return_inverse=True)
        xn = (z * z).sum(1)
        kth = torch.empty(uniq.size, dtype=torch.float64, device=z.device)
        u = torch.from_numpy(uniq).to(z.device)
        for c0 in range(0, uniq.size, _EXACT_CHUNK):
            q = z[u[c0:c0 + _EXACT_CHUNK]]
            s = -(xn[None, :] + (q * q).sum(1)[:, None] - 2.0 * q @ z.T)
            kth[c0:c0 + _EXACT_CHUNK] = torch.topk(
                s, self.k_top, dim=1).values[:, -1]
        tol = 1e-6 * ((z * z).sum(1).max() * 2.0)
        hits = 0.0
        for c0 in range(0, rows.size, _RECALL_CHUNK):
            r = torch.from_numpy(rows[c0:c0 + _RECALL_CHUNK]).to(z.device)
            i = ids[c0:c0 + _RECALL_CHUNK]
            safe = torch.from_numpy(np.maximum(i, 0)).to(z.device)
            got = -((z[r][:, None, :] - z[safe]) ** 2).sum(-1)
            kth_r = kth[torch.from_numpy(inv[c0:c0 + _RECALL_CHUNK]).to(
                z.device)]
            counts = torch.from_numpy((i >= 0) & first_seen(i)).to(z.device)
            hit = (got >= kth_r[:, None] - tol) & counts
            hits += float(hit.sum().item())
        return hits / (rows.size * self.k_top)

    def free(self) -> None:
        self.service = None
        self.emb = None

    def check(self, dtype=None) -> dict:
        """``score_gap``, ``foreign`` and ``repeats`` over a seeded sample
        of whole flushes of the window.  ``dtype`` puts the reference, in
        that precision, in the program's place (the control)."""
        src, dst = ref.symmetrize(self.host["src"], self.host["dst"])
        lap, diag, cor = self.options
        zref = ref.embed(ref.prepare(src, dst, self.n, laplacian=lap,
                                     diag_aug=diag),
                         self.host["labels"], self.k, correlation=cor)
        index = ivf.build(zref, self.host["labels"], self.k)
        nprobe = self.traffic["nprobe"]
        rng = np.random.default_rng([self.seed % (1 << 63), 4])
        pick = rng.choice(len(self.asked), size=min(
            len(self.asked), int(self.traffic["check_flushes"])),
            replace=False)
        gap, foreign, repeats, work = 0.0, 0, 0, np.zeros(3)
        for f in pick:
            rows = self.queries[self.asked[f]]
            if dtype is None:
                ids, scores = self.ids[f], self.scores[f]
            else:
                ids, scores = ivf.search(index, zref, rows, self.k_top,
                                         nprobe=nprobe, dtype=dtype)
            v = ivf.judge(index, rows, ids, scores, nprobe=nprobe)
            gap = max(gap, v["score_gap"])
            foreign += v["foreign"]
            repeats += v["repeats"]
            work += (v["pairs"], v["distinct_rows"], rows.size)
        self._work = tuple(work / max(len(pick), 1))
        return {"score_gap": gap, "foreign": foreign, "repeats": repeats}

    def reader_context(self) -> dict:
        bound = None
        work = getattr(self, "_work", None)
        if self.device.type == "cuda" and work is not None:
            peak = roofline.peaks(torch.cuda.get_device_name(self.device))
            pairs, distinct, queries = work
            bound = roofline.bound_seconds(
                roofline.flush_bytes(distinct, queries, self.k, self.k_top),
                roofline.flush_flops(pairs, distinct, queries, self.k), peak)
        return {"setup": {"cold_fit_ms": self.cold_fit_ms,
                          "index_build_ms": self.index_build_ms},
                "bound_s_per_unit": bound}
