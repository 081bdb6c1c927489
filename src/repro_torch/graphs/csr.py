"""CSR/CSC graph representations.

ATLAS stores topology in CSR (out-edges per source vertex) because the
broadcast execution model streams *source* vertices sequentially and pushes
messages along out-edges (paper §3.2). The gather baselines need CSC
(in-edges per destination). Both are plain NumPy struct-of-arrays so they
can be memory-mapped from disk by the storage layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row topology.

    ``indptr[u] : indptr[u+1]`` spans the out-neighbors of vertex ``u`` in
    ``indices``.  ``num_vertices == len(indptr) - 1``.
    """

    indptr: np.ndarray  # int64 [V+1]
    indices: np.ndarray  # int32/int64 [E]

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indptr[-1])

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def edges_for_range(self, start: int, end: int) -> tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) arrays for all out-edges of vertices [start, end).

        This is the unit of work the graph reader hands to the orchestrator
        per chunk: topology for a contiguous source-vertex range.
        """
        lo, hi = self.indptr[start], self.indptr[end]
        dst = self.indices[lo:hi]
        counts = np.diff(self.indptr[start : end + 1])
        src = np.repeat(np.arange(start, end, dtype=dst.dtype), counts)
        return src, dst

    def validate(self) -> None:
        if self.indptr[0] != 0:
            raise ValueError("indptr must start at 0")
        if np.any(np.diff(self.indptr) < 0):
            raise ValueError("indptr must be non-decreasing")
        if self.num_edges != len(self.indices):
            raise ValueError("indptr[-1] must equal len(indices)")
        if len(self.indices) and (
            self.indices.min() < 0 or self.indices.max() >= self.num_vertices
        ):
            raise ValueError("edge endpoints out of range")


def build_csr(src: np.ndarray, dst: np.ndarray, num_vertices: int) -> CSRGraph:
    """Build CSR (grouped by source) from an edge list. O(E) counting sort."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    counts = np.bincount(src, minlength=num_vertices).astype(np.int64)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(src, kind="stable")
    indices = dst[order].astype(np.int32)
    return CSRGraph(indptr=indptr, indices=indices)


def build_csc(src: np.ndarray, dst: np.ndarray, num_vertices: int) -> CSRGraph:
    """Build CSC (grouped by destination): CSR of the reversed edges."""
    return build_csr(dst, src, num_vertices)


def csr_to_csc(csr: CSRGraph) -> CSRGraph:
    src, dst = csr.edges_for_range(0, csr.num_vertices)
    return build_csc(src, dst, csr.num_vertices)


def degrees_from_csr(csr: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    """Return (in_degree, out_degree) for the CSR (out-edge) topology."""
    out_deg = csr.out_degree().astype(np.int64)
    in_deg = np.bincount(csr.indices, minlength=csr.num_vertices).astype(np.int64)
    return in_deg, out_deg


def add_self_loops(csr: CSRGraph) -> CSRGraph:
    """Return a new CSR with self-loops added to every vertex (GCN-style).

    Idempotent-ish: does not dedupe pre-existing self loops; callers using
    GCN normalisation should start from a loop-free edge list.
    """
    v = csr.num_vertices
    src, dst = csr.edges_for_range(0, v)
    loop = np.arange(v, dtype=src.dtype if len(src) else np.int64)
    return build_csr(
        np.concatenate([src, loop]), np.concatenate([dst, loop]), v
    )
