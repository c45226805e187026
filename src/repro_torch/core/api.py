"""Public API: ``GEEEmbedder`` (port of the in-memory part of
``repro/core/api.py``).

The embedder runs on the card unless the caller asks for the CPU:
``device=None`` resolves to ``cuda`` and raises ``RuntimeError`` when no GPU
is present.  ``backend="auto"`` picks the hand-written kernels on the card
(``repro_torch.core.plan.select_backend``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.gee import GEEOptions
from repro_torch.core.plan import GEEPlan, PreparedGraph
from repro_torch.graph.containers import EdgeList


@dataclasses.dataclass
class GEEEmbedder:
    """Fit/transform-style wrapper around GEE.

    backend: 'auto' (default: ``cuda`` on the card, ``sparse_torch`` on
             the CPU), 'cuda', 'sparse_torch', 'scipy' or 'python_loop'.
    device:  where the graph and the embedding live; ``None`` is the card.
    """

    num_classes: int
    options: GEEOptions = GEEOptions(laplacian=True, diag_aug=True,
                                     correlation=True)
    backend: str = "auto"
    device: Optional[str] = None

    _prepared: Optional[PreparedGraph] = dataclasses.field(default=None,
                                                          repr=False)
    _labels: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _z: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    # -- construction helpers ------------------------------------------------
    @staticmethod
    def from_arrays(src, dst, weight, labels, num_classes: int,
                    num_nodes: int | None = None, undirected: bool = True,
                    **kw) -> "GEEEmbedder":
        emb = GEEEmbedder(num_classes=num_classes, **kw)
        prepared = PreparedGraph.from_arrays(
            src, dst, weight, num_nodes=num_nodes, undirected=undirected,
            device=resolve_device(emb.device))
        return emb.fit(prepared, labels)

    # -- sklearn-ish surface -------------------------------------------------
    def fit(self, edges: "EdgeList | PreparedGraph", labels) -> "GEEEmbedder":
        """Fit an in-memory graph, moved to this embedder's device.  A
        ``PreparedGraph`` already there keeps its memoized prep artifacts
        (refits, backend switches and option sweeps then share them)."""
        device = resolve_device(self.device)
        prepared = PreparedGraph.wrap(edges)
        if prepared.device != device:
            prepared = PreparedGraph(prepared.base.to(device))
        self._prepared = prepared
        self._labels = torch.as_tensor(labels).to(device=device,
                                                  dtype=torch.int32)
        self._z = None
        return self

    @property
    def prepared(self) -> Optional[PreparedGraph]:
        """The fitted graph's memoized prep artifacts."""
        return self._prepared

    def transform(self) -> torch.Tensor:
        if self._prepared is None:
            raise RuntimeError("call fit() first")
        if self._z is None:
            self._z = GEEPlan.build(
                self._prepared, self.num_classes, self.options,
                backend=self.backend).execute(self._labels)
        return self._z

    def fit_transform(self, edges: "EdgeList | PreparedGraph",
                      labels) -> torch.Tensor:
        return self.fit(edges, labels).transform()

    # -- classification on top of the embedding ------------------------------
    def class_means(self) -> torch.Tensor:
        """Per-class mean of Z over labeled vertices, [K, K]; empty classes
        get ``inf`` rows so ``predict`` never assigns to them."""
        z = self.transform()
        onehot = torch.zeros((z.shape[0], self.num_classes), dtype=z.dtype,
                             device=z.device)
        valid = self._labels >= 0
        onehot[valid, self._labels[valid].long()] = 1.0
        counts = onehot.sum(0)
        means = (onehot.T @ z) / torch.clamp(counts, min=1.0)[:, None]
        return torch.where((counts > 0)[:, None], means,
                           torch.full_like(means, float("inf")))

    def predict(self, rows=None) -> torch.Tensor:
        """Nearest-class-mean vertex classification.  ``rows`` restricts to
        a vertex subset (any array-like of ids; always returns 1-D)."""
        z = self.transform()
        if rows is not None:
            idx = torch.as_tensor(rows, device=z.device).long().reshape(-1)
            z = z[idx]
        means = self.class_means()
        d2 = torch.sum((z[:, None, :] - means[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(torch.isnan(d2), torch.full_like(d2, float("inf")),
                         d2)
        return torch.argmin(d2, dim=-1).to(torch.int32)


__all__ = ["GEEEmbedder"]
