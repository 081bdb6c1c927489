from repro_torch.core.atlas import AtlasConfig, AtlasEngine, LayerMetrics
from repro_torch.core.eviction import (
    ArrayLRUPolicy,
    ArrayMinPendingPolicy,
    ArrayRandomPolicy,
    LRUPolicy,
    MinPendingPolicy,
    RandomPolicy,
    make_policy,
)
from repro_torch.core.orchestrator import COLD, COMPLETED, HOT, NOT_STARTED, Orchestrator
from repro_torch.core.reorder import atlas_order, make_order, relabel_graph

__all__ = [
    "AtlasConfig",
    "AtlasEngine",
    "LayerMetrics",
    "MinPendingPolicy",
    "LRUPolicy",
    "RandomPolicy",
    "ArrayMinPendingPolicy",
    "ArrayLRUPolicy",
    "ArrayRandomPolicy",
    "make_policy",
    "Orchestrator",
    "NOT_STARTED",
    "HOT",
    "COLD",
    "COMPLETED",
    "atlas_order",
    "make_order",
    "relabel_graph",
]
