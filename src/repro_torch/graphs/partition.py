"""Vertex-ID range partitioning.

ATLAS range-partitions features and embeddings by vertex ID (paper §3.2):
sequential writes within each partition without a global external sort, and
the same ranges drive (a) the writer's spill buffers, (b) the reader's
merge-on-read, and (c) in distributed mode, the destination-shard ownership
for the all_to_all message exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RangePartition:
    """``num_vertices`` split into ``num_parts`` contiguous ID ranges."""

    num_vertices: int
    num_parts: int

    def __post_init__(self):
        if self.num_parts <= 0 or self.num_vertices < 0:
            raise ValueError("invalid partition spec")

    @property
    def bounds(self) -> np.ndarray:
        """[num_parts+1] partition boundaries (balanced, first parts larger)."""
        base, rem = divmod(self.num_vertices, self.num_parts)
        sizes = np.full(self.num_parts, base, dtype=np.int64)
        sizes[:rem] += 1
        out = np.zeros(self.num_parts + 1, dtype=np.int64)
        np.cumsum(sizes, out=out[1:])
        return out

    def part_of(self, vertex_ids: np.ndarray) -> np.ndarray:
        """Partition index for each vertex id (vectorised)."""
        return (
            np.searchsorted(self.bounds, np.asarray(vertex_ids), side="right") - 1
        ).astype(np.int32)

    def range_of(self, part: int) -> tuple[int, int]:
        b = self.bounds
        return int(b[part]), int(b[part + 1])

    def size_of(self, part: int) -> int:
        lo, hi = self.range_of(part)
        return hi - lo
