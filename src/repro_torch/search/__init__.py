"""Vertex-similarity retrieval over GEE embeddings (port of
``repro/search``): the class-partitioned index
(:mod:`repro_torch.search.index`) and the batched query service
(:mod:`repro_torch.search.service`).  ``GEEDeltaServer`` waits for the
port of incremental updates.
"""

from repro_torch.search.index import ClassPartitionedIndex, default_nprobe
from repro_torch.search.service import (GEEQueryService, LoadShedError,
                                        QueryTicket)

__all__ = ["ClassPartitionedIndex", "default_nprobe", "GEEQueryService",
           "LoadShedError", "QueryTicket"]
