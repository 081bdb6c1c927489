"""Shard planning: contiguous internal-ID ranges over one store namespace.

A shard owns a contiguous range of *internal* (storage-order) vertex ids —
the same balanced split ``RangePartition`` gives the writer's spill
buffers, so shard boundaries compose with the store's PR-8 ordering: the
permutation is applied at store build, every shard speaks internal ids,
and the plan pins the store's ordering digest so a plan computed against
one physical order can never silently drive a store rebuilt under
another.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.partition import RangePartition


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """``num_vertices`` internal ids split into ``num_shards`` contiguous
    ranges.  ``store_digest`` (optional) records the vertex-namespace
    identity the plan was built for."""

    num_vertices: int
    num_shards: int
    store_digest: str = ""

    def __post_init__(self):
        if self.num_shards <= 0:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.num_vertices < self.num_shards:
            raise ValueError(
                f"cannot split {self.num_vertices} vertices into "
                f"{self.num_shards} non-empty shards"
            )

    @property
    def _partition(self) -> RangePartition:
        return RangePartition(self.num_vertices, self.num_shards)

    @property
    def bounds(self) -> np.ndarray:
        """[num_shards+1] shard boundaries (balanced, first shards larger)."""
        return self._partition.bounds

    def range_of(self, shard: int) -> tuple[int, int]:
        """Internal-id range ``[lo, hi)`` owned by ``shard``."""
        return self._partition.range_of(shard)

    def size_of(self, shard: int) -> int:
        lo, hi = self.range_of(shard)
        return hi - lo

    def shard_of(self, vertex_ids: np.ndarray) -> np.ndarray:
        """Owning shard for each internal vertex id (vectorised)."""
        return self._partition.part_of(vertex_ids)

    def validate_store(self, store) -> None:
        """Fail fast when the plan's pinned namespace does not match the
        store (the store was rebuilt under a different ordering)."""
        if store.num_vertices != self.num_vertices:
            raise ValueError(
                f"shard plan covers {self.num_vertices} vertices, store has "
                f"{store.num_vertices}"
            )
        if self.store_digest and store.ordering_digest != self.store_digest:
            raise ValueError(
                f"shard plan was built for store digest {self.store_digest}, "
                f"store now has {store.ordering_digest} (ordering "
                f"{store.ordering_name!r}) — rebuild the plan"
            )
