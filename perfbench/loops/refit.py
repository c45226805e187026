"""Refit traffic: warm ``GEEEmbedder.fit_transform`` on one prepared graph.

Set-up draws the graph on the device, symmetrizes it through the port,
wraps it in one ``PreparedGraph`` and builds the kernels
(``graphs.prepare``); makes the first (cold) fit, which packs the graph
on the host; and warms every option setting the mix uses.  A fold is the true labels with a seeded share set
to -1 (unknown), as one fold of the paper's cross-validation; set-up draws
a pool of them and the window cycles it, so no fit sees its predecessor's
labels.  The labels reach the program as host numpy arrays, as a caller's
would.

A unit is a group: ``group`` fits dispatched one after another (option
settings cycled in the mix's order), then the group's embeddings copied
into host buffers made once; the group ends when all are there.
``fit_ms`` is the window over the fits it completed.

The check keeps a seeded reservoir of each setting's fits (their host Z)
and holds each against the float64 reference on the same graph and fold.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.api import GEEEmbedder
from repro_torch.core.gee import GEEOptions

from perfbench import graphs, roofline
from perfbench.reference import gee as ref

_FLAGS = ("laplacian", "diag_aug", "correlation")


def _settings(cfg: dict, traffic: dict) -> list:
    raw = traffic.get("settings", "config")
    if raw == "config":
        return [tuple(bool(cfg["options"][f]) for f in _FLAGS)]
    return [tuple(bool(v) for v in s) for s in raw]


class Loop:
    units = "fits"

    def __init__(self, cfg, traffic, seed, device, clock):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.group = int(traffic["group"])
        self.settings = _settings(cfg, traffic)

        graph = graphs.prepare(cfg, seed, self.device, clock)
        prepared, self.host = graph.prepared, graph.host
        n, k = graph.n, graph.k
        self.n, self.k = n, k
        self.directed_edges = prepared.num_edges
        rng = np.random.default_rng([self.seed % (1 << 63), 1])
        hide = rng.random((int(traffic["folds"]), n)) \
            < float(traffic["unlabeled_share"])
        self.folds = [np.where(h, -1, self.host["labels"]).astype(np.int32)
                      for h in hide]
        clock.phase("synthesis")

        self.prepared = prepared
        self.embs = [GEEEmbedder(num_classes=k,
                                 options=GEEOptions(*s), device=str(
                                     self.device))
                     for s in self.settings]
        t0 = time.perf_counter()
        self.embs[0].fit_transform(prepared, self.folds[0]).cpu()
        self.cold_fit_ms = (time.perf_counter() - t0) * 1e3
        clock.phase("cold_fit")

        # The group's embeddings land in host buffers made once (pinned on
        # the card's host), as a consumer that keeps its buffers would
        # have them: the window times the fits, not page faults of fresh
        # host memory.
        self._host = torch.empty((self.group, n, k), dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")
        self.fits = 0
        self.enqueue_ms = []
        self.host_samples = {"enqueue_ms": self.enqueue_ms}
        self._res_rng = np.random.default_rng([self.seed % (1 << 63), 2])
        self._res_cap = max(1, -(-int(traffic["check_fits"])
                                 // len(self.settings)))
        self.reservoir = [[] for _ in self.settings]
        self._seen = [0] * len(self.settings)
        self.shape_errors = 0
        for _ in range(int(traffic["warmup_groups"])):
            self._group(keep=False)
        self._sync()
        self.fits = 0
        self.enqueue_ms.clear()
        clock.phase("warmup")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _group(self, keep: bool) -> int:
        zs, meta = [], []
        for j in range(self.group):
            i = self.fits + j
            s = i % len(self.settings)
            fold = i % len(self.folds)
            t0 = time.perf_counter()
            z = self.embs[s].fit_transform(self.prepared, self.folds[fold])
            self.enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            zs.append(z)
            meta.append((i, s, fold))
        for j, z in enumerate(zs):
            if tuple(z.shape) == (self.n, self.k):
                self._host[j].copy_(z, non_blocking=True)
            else:
                self.shape_errors += 1
        self._sync()
        if keep:
            for (i, s, fold), z in zip(meta, self._host):
                self._offer(s, i, fold, z)
        self.fits += self.group
        return self.group

    def _offer(self, s: int, i: int, fold: int, z: torch.Tensor) -> None:
        """Seeded reservoir sampling, one reservoir a setting; a fit kept
        is a copy of its host buffer."""
        self._seen[s] += 1
        res = self.reservoir[s]
        if len(res) < self._res_cap:
            res.append((i, fold, z.clone()))
            return
        j = int(self._res_rng.integers(0, self._seen[s]))
        if j < self._res_cap:
            res[j] = (i, fold, z.clone())

    def unit(self) -> int:
        return self._group(keep=True)

    def finish(self) -> None:
        self._sync()

    def attempted(self) -> tuple:
        return self.fits, self.shape_errors

    def end_to_end(self, seconds: float) -> dict:
        return {"fit_ms": seconds * 1e3 / max(self.fits, 1)}

    def free(self) -> None:
        self.embs = None
        self.prepared = None

    def check(self, dtype=None) -> dict:
        """``z_err`` over the reservoir's fits.  ``dtype`` puts the
        reference, in that precision, in the program's place (the
        control)."""
        src, dst = ref.symmetrize(self.host["src"], self.host["dst"])
        worst = 0.0
        for s, res in enumerate(self.reservoir):
            if not res:
                continue
            lap, diag, cor = self.settings[s]
            want_prep = ref.prepare(src, dst, self.n, laplacian=lap,
                                    diag_aug=diag)
            got_prep = want_prep if dtype is None else ref.prepare(
                src, dst, self.n, laplacian=lap, diag_aug=diag, dtype=dtype)
            for _, fold, z in res:
                want = ref.embed(want_prep, self.folds[fold], self.k,
                                 correlation=cor)
                got = z.numpy() if dtype is None else ref.embed(
                    got_prep, self.folds[fold], self.k, correlation=cor)
                worst = max(worst, ref.z_err(got, want))
        return {"z_err": worst}

    def reader_context(self) -> dict:
        peak = None
        if self.device.type == "cuda":
            peak = roofline.peaks(torch.cuda.get_device_name(self.device))
        bound = None if peak is None else roofline.bound_seconds(
            roofline.fit_bytes(self.directed_edges, self.n, self.k),
            roofline.fit_flops(self.directed_edges, self.n, self.k), peak)
        return {"setup": {"cold_fit_ms": self.cold_fit_ms},
                "bound_s_per_unit": None if bound is None
                else bound * self.group}
