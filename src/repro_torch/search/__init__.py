"""Vertex-similarity retrieval over GEE embeddings (port of
``repro/search``): the class-partitioned index
(:mod:`repro_torch.search.index`) and the batched query service
(:mod:`repro_torch.search.service`), with the delta server that keeps
them fresh under streaming updates.
"""

from repro_torch.search.index import ClassPartitionedIndex, default_nprobe
from repro_torch.search.service import (GEEDeltaServer, GEEQueryService,
                                        LoadShedError, QueryTicket)

__all__ = ["ClassPartitionedIndex", "default_nprobe", "GEEQueryService",
           "GEEDeltaServer", "LoadShedError", "QueryTicket"]
