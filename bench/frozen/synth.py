"""Seeded graph generators, frozen.

Copied from ``src/repro_torch/graphs/synth.py`` (``powerlaw_graph``,
``uniform_graph``) and ``src/repro_torch/graphs/csr.py`` (``build_csr``)
at commit 4cdb0a73912ceae5e46a51aa52d89d73ba4acce5.  The draws, their
order and the CSR layout are unchanged, so a seed gives the same graph
as the program's generators did at that commit
(``bench/tests/test_bench_reference.py`` holds them equal).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR topology: ``indptr[u]:indptr[u+1]`` spans the out-neighbours
    (destinations) of source ``u`` in ``indices``."""

    indptr: np.ndarray  # int64 [V+1]
    indices: np.ndarray  # int32 [E]

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indptr[-1])

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """``(src, dst)`` of every edge, grouped by source."""
        src = np.repeat(np.arange(self.num_vertices, dtype=np.int64), np.diff(self.indptr))
        return src, self.indices.astype(np.int64)


def build_csr(src: np.ndarray, dst: np.ndarray, num_vertices: int) -> Graph:
    """CSR grouped by source from an edge list (stable counting order)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    counts = np.bincount(src, minlength=num_vertices).astype(np.int64)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(src, kind="stable")
    indices = dst[order].astype(np.int32)
    return Graph(indptr=indptr, indices=indices)


def powerlaw_graph(num_vertices: int, avg_degree: float, seed: int = 0,
                   exponent: float = 1.05, self_loops: bool = True) -> Graph:
    """Heavy-tailed in-degree: destinations drawn from a Zipf-like law over
    a permuted id space (hubs spread over the ids), sources uniform."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    weights = ranks ** (-exponent)
    weights /= weights.sum()
    perm = rng.permutation(num_vertices)
    dst = perm[rng.choice(num_vertices, size=num_edges, p=weights)]
    src = rng.integers(0, num_vertices, size=num_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if self_loops:
        loop = np.arange(num_vertices, dtype=src.dtype)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    return build_csr(src, dst, num_vertices)


def uniform_graph(num_vertices: int, avg_degree: float, seed: int = 0,
                  self_loops: bool = True) -> Graph:
    """Erdos-Renyi-style directed graph (uniform endpoints): no hubs."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    src = rng.integers(0, num_vertices, size=num_edges)
    dst = rng.integers(0, num_vertices, size=num_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if self_loops:
        loop = np.arange(num_vertices, dtype=src.dtype)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    return build_csr(src, dst, num_vertices)


GENERATORS = {"powerlaw": powerlaw_graph, "uniform": uniform_graph}
