"""Gather-based baselines (paper §2.2-2.3, Fig 1/4 comparison points).

* ``layerwise_gather`` — DGI-style: layer-at-a-time, but each destination
  batch *pulls* its in-neighbors' rows from disk.  Reads are accounted at
  block granularity (4 KiB default): scattered single-row reads fetch whole
  blocks, and rows shared across batches are re-fetched — read volume
  scales with |E|, not |V|.
* ``vertexwise_gather`` — Ginex-style inference: per target batch, expand
  the full (unsampled) k-hop computation graph and pull every feature it
  needs; redundant both in I/O and compute.

Both produce numerically correct outputs (same oracle semantics), so the
benchmark compares *systems*, not approximations.

Port notes: the embeddings ``h`` live on ``device`` across layers.  A
batch's edges are grouped by destination (CSC order, or the sorted
frontier), so their sum is kernel K1's ``segment_reduce_sorted`` over
``h`` in edge order — no float atomics — and the transform is K2 through
``layer_update``.  The I/O model (``BlockAccountant``, ``GatherStats``)
is host numpy and counts exactly what the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, csr_to_csc, degrees_from_csr
from repro_torch.kernels.edge_block_spmm import segment_reduce_sorted
from repro_torch.models.gnn import (
    GNNLayerSpec,
    edge_weights,
    layer_update,
    self_coefficient,
)


@dataclasses.dataclass
class GatherStats:
    bytes_read: int = 0
    block_reads: int = 0
    rows_requested: int = 0
    compute_vertex_visits: int = 0


class BlockAccountant:
    """Models disk reads at block granularity over a row-major feature file.

    A batch's row set is deduplicated (an in-memory batch buffer, like
    DGI's), but nothing is cached *across* batches — matching the paper's
    observation that OOC gather re-fetches shared rows once per batch.
    """

    def __init__(self, row_bytes: int, block_bytes: int = 4096):
        self.row_bytes = row_bytes
        self.block_bytes = block_bytes

    def bytes_for_rows(self, row_ids: np.ndarray) -> tuple[int, int]:
        if len(row_ids) == 0:
            return 0, 0
        row_ids = np.unique(row_ids)
        starts = row_ids.astype(np.int64) * self.row_bytes
        ends = starts + self.row_bytes
        first_blk = starts // self.block_bytes
        last_blk = (ends - 1) // self.block_bytes
        # count distinct blocks across all row extents
        blocks = np.unique(_ranges(first_blk, last_blk - first_blk + 1))
        return len(blocks) * self.block_bytes, len(blocks)


def _ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s + n) for s, n in zip(starts, lengths)])``
    without the Python loop."""
    lengths = np.asarray(lengths, dtype=np.int64)
    offs = np.cumsum(lengths) - lengths
    return np.repeat(np.asarray(starts, np.int64) - offs, lengths) + np.arange(
        int(lengths.sum()), dtype=np.int64
    )


def _on(dev, a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _segment_sum(h, src_rows, w, counts, dev) -> torch.Tensor:
    """``[len(counts), d]`` f32: segment ``i`` sums ``w·h[src_rows]`` over
    its ``counts[i]`` edges, which come grouped by segment (K1)."""
    offsets = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return segment_reduce_sorted(
        h, _on(dev, src_rows, np.int32), _on(dev, w, np.float32),
        _on(dev, offsets, np.int32),
    )


def _with_self(spec: GNNLayerSpec, agg: torch.Tensor, self_rows: torch.Tensor):
    if spec.kind == "sage":
        return torch.cat([self_rows * self_coefficient(spec), agg], dim=1)
    if spec.kind == "gin":
        return agg + self_rows * self_coefficient(spec)
    return agg


def layerwise_gather(
    csr: CSRGraph,
    features: np.ndarray,
    specs: list[GNNLayerSpec],
    batch_size: int = 4096,
    block_bytes: int = 4096,
    device="cuda",
) -> tuple[np.ndarray, GatherStats]:
    """DGI-style layer-wise inference with per-batch neighbor gathers, on
    ``device``."""
    dev = resolve_device(device)
    csc = csr_to_csc(csr)  # in-neighbors per destination
    in_deg, _ = degrees_from_csr(csr)
    stats = GatherStats()
    h = _on(dev, features, np.float32)
    v = csr.num_vertices
    for spec in specs:
        spec_dev = spec.to(dev)  # weights uploaded once per layer
        acct = BlockAccountant(spec.in_dim * 4, block_bytes)
        out = torch.empty((v, spec.out_dim), dtype=torch.float32, device=dev)
        for s in range(0, v, batch_size):
            e = min(s + batch_size, v)
            dst_local = np.arange(s, e)
            # pull in-neighbor lists (CSC) for this destination batch
            lo, hi = csc.indptr[s], csc.indptr[e]
            src = np.asarray(csc.indices[lo:hi], dtype=np.int64)
            counts = np.diff(csc.indptr[s : e + 1])
            dst = np.repeat(dst_local, counts)
            # disk model: gather unique neighbor rows at block granularity
            need = np.unique(np.concatenate([src, dst_local]))
            b, n = acct.bytes_for_rows(need)
            stats.bytes_read += b
            stats.block_reads += n
            stats.rows_requested += len(need)
            w = edge_weights(spec.kind, src, dst, in_deg)
            agg = _segment_sum(h, src, w, counts, dev)
            out[s:e] = layer_update(spec_dev, _with_self(spec, agg, h[s:e]))
            stats.compute_vertex_visits += e - s
        h = out
    return h.cpu().numpy(), stats


def vertexwise_gather(
    csr: CSRGraph,
    features: np.ndarray,
    specs: list[GNNLayerSpec],
    batch_size: int = 1024,
    block_bytes: int = 4096,
    device="cuda",
) -> tuple[np.ndarray, GatherStats]:
    """Ginex-style inference: per batch, materialise the full k-hop
    computation graph and recompute every intermediate — neighborhood
    explosion in both reads and compute (paper challenge (3)) — on
    ``device``."""
    dev = resolve_device(device)
    csc = csr_to_csc(csr)
    in_deg, _ = degrees_from_csr(csr)
    stats = GatherStats()
    v = csr.num_vertices
    L = len(specs)
    feat = _on(dev, features, np.float32)
    out = torch.empty((v, specs[-1].out_dim), dtype=torch.float32, device=dev)
    acct = BlockAccountant(specs[0].in_dim * 4, block_bytes)
    specs_dev = [spec.to(dev) for spec in specs]

    def in_neighbors(vs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        counts = (csc.indptr[vs + 1] - csc.indptr[vs]).astype(np.int64)
        idx = np.asarray(csc.indices[_ranges(csc.indptr[vs], counts)])
        return idx.astype(np.int64), counts

    for s in range(0, v, batch_size):
        e = min(s + batch_size, v)
        # frontier expansion: layers deep -> shallow; every frontier is
        # sorted (arange, then np.unique), so a row's position in one is
        # a binary search
        frontiers = [np.arange(s, e, dtype=np.int64)]
        for _ in range(L):
            src, _ = in_neighbors(frontiers[-1])
            frontiers.append(np.unique(np.concatenate([frontiers[-1], src])))
        needed = frontiers[-1]
        b, n = acct.bytes_for_rows(needed)
        stats.bytes_read += b
        stats.block_reads += n
        stats.rows_requested += len(needed)
        # forward over the computation graph: hcur holds the rows of
        # `rows` (the previous frontier) in its order
        rows = needed
        hcur = feat[_on(dev, needed, np.int64)]
        for li, spec in enumerate(specs):
            tgt = frontiers[L - 1 - li]
            src, counts = in_neighbors(tgt)
            # tgt is sorted, so edges repeated per target come grouped by
            # target: the segments of K1
            dstrep = np.repeat(tgt, counts)
            w = edge_weights(spec.kind, src, dstrep, in_deg)
            agg = _segment_sum(hcur, np.searchsorted(rows, src), w, counts, dev)
            self_rows = hcur[_on(dev, np.searchsorted(rows, tgt), np.int64)]
            hcur = layer_update(specs_dev[li], _with_self(spec, agg, self_rows))
            stats.compute_vertex_visits += len(tgt)
            rows = tgt
        out[s:e] = hcur  # the last frontier is arange(s, e) itself
    return out.cpu().numpy(), stats


__all__ = [
    "BlockAccountant",
    "GatherStats",
    "layerwise_gather",
    "vertexwise_gather",
]
