"""Broadcast chunk compute core (paper §3.1, Fig 2c).

For one streamed chunk of source vertices, construct all outgoing messages
(m_{u->v} = w(u,v) * h_u) and pre-aggregate them *by destination* so the
memory manager touches each destination slot exactly once per chunk.

Three backends, selected by ``AtlasConfig.backend``:

  * cuda  — the default: kernel K1 (``kernels/edge_block_spmm.py``) on the
            GPU, fed through reused pinned host buffers on the
            aggregator's own CUDA stream,
  * cpu   — the same aggregator on the CPU, where K1's wrapper runs its
            plain PyTorch version,
  * numpy — ``chunk_aggregate_numpy``, the host oracle carried over from
            the JAX package (sort-by-destination + ``np.add.reduceat``).

All backends share one contract::

    (unique_dst int64 [s], partial float32 [s, d], counts int64 [s])

with ``unique_dst`` sorted ascending — callers (``_deliver``) rely on one
row per distinct destination.  The cuda/cpu backends build the chunk's
destination dictionary (stable sort by destination, segment starts and
counts) on the host with numpy, exactly as the numpy oracle does, so
``unique_dst`` and ``counts`` agree with it bit for bit; only the
segment sums run on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import PinnedStaging, resolve_device
from repro_torch.kernels.edge_block_spmm import segment_reduce_sorted
from repro_torch.obs.trace import NULL_TRACER


def chunk_aggregate_numpy(
    feats: np.ndarray,  # [n, d] chunk features (source rows)
    src_local: np.ndarray,  # [m] edge sources, chunk-local indices
    dst: np.ndarray,  # [m] edge destinations, global ids
    weights: np.ndarray,  # [m] per-edge scalars
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (unique_dst, partial_sums[, counts]): one row per distinct
    destination touched by this chunk."""
    if len(dst) == 0:
        return (
            np.empty(0, dtype=np.int64),
            np.empty((0, feats.shape[1]), dtype=np.float32),
            np.empty(0, dtype=np.int64),
        )
    order = np.argsort(dst, kind="stable")
    sdst = dst[order]
    msgs = feats[src_local[order]].astype(np.float32)
    msgs *= weights[order][:, None]
    # segment boundaries over the destination-sorted edge list
    starts = np.nonzero(np.r_[True, sdst[1:] != sdst[:-1]])[0]
    unique_dst = sdst[starts].astype(np.int64)
    partial = np.add.reduceat(msgs, starts, axis=0)
    counts = np.diff(np.r_[starts, len(sdst)]).astype(np.int64)
    return unique_dst, partial, counts


class ChunkAggregator:
    """K1 as a ``chunk_aggregate`` backend on ``device``.

    CUDA: the chunk's operands go through reused pinned buffers with
    ``non_blocking`` copies on the aggregator's own stream (so the
    staging thread never serializes behind the default stream), K1 runs
    on that stream, and ``partial`` comes back with one synchronous d2h.
    ``h2d_seconds`` sums the copies' device time, read from CUDA events.
    CPU: the same host dictionary, then K1's plain version.
    """

    def __init__(self, device) -> None:
        self.device = resolve_device(device)
        self.backend = self.device.type
        self.h2d_seconds = 0.0
        self.tracer = NULL_TRACER
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pinned = PinnedStaging()

    def __call__(self, feats, src_local, dst, weights):
        n, d = feats.shape
        m = len(dst)
        if m == 0:
            return (
                np.empty(0, dtype=np.int64),
                np.empty((0, d), dtype=np.float32),
                np.empty(0, dtype=np.int64),
            )
        if n >= 2**31 or m >= 2**31:
            raise ValueError(f"chunk too large for int32 indices: n={n}, m={m}")
        order = np.argsort(dst, kind="stable")
        sdst = dst[order]
        starts = np.nonzero(np.r_[True, sdst[1:] != sdst[:-1]])[0]
        unique_dst = sdst[starts].astype(np.int64)
        counts = np.diff(np.r_[starts, m]).astype(np.int64)
        ops = dict(
            feats=np.ascontiguousarray(feats, np.float32),
            src=src_local[order].astype(np.int32),
            w=weights[order].astype(np.float32),
            offsets=np.r_[starts, m].astype(np.int32),
        )
        if self.device.type == "cpu":
            t = {k: torch.from_numpy(v) for k, v in ops.items()}
            partial = segment_reduce_sorted(t["feats"], t["src"], t["w"], t["offsets"])
            return unique_dst, partial.numpy(), counts
        return unique_dst, self._run_cuda(ops, len(starts), d), counts

    def _run_cuda(self, ops: dict, num_seg: int, d: int) -> np.ndarray:
        with self.tracer.span("h2d", "h2d"):
            host = self._pinned.fill(**ops)
            with torch.cuda.stream(self._stream):
                start = torch.cuda.Event(enable_timing=True)
                copied = torch.cuda.Event(enable_timing=True)
                start.record()
                dev = {
                    k: v.to(self.device, non_blocking=True) for k, v in host.items()
                }
                copied.record()
                self._pinned.copied(copied)
        with torch.cuda.stream(self._stream):
            out = segment_reduce_sorted(dev["feats"], dev["src"], dev["w"], dev["offsets"])
            partial = np.empty((num_seg, d), dtype=np.float32)
            # synchronous on this stream: partial is complete on return
            torch.from_numpy(partial).copy_(out)
        self.h2d_seconds += start.elapsed_time(copied) / 1e3
        return partial


def chunk_aggregate(backend: str = "cuda"):
    """Resolve a backend name to a callable with the shared contract.

    ``numpy`` is stateless; ``cuda``/``cpu`` return a fresh aggregator
    object (call once per layer — it carries its stream and pinned
    buffers).  ``cuda`` raises ``RuntimeError`` without a CUDA device."""
    if backend == "numpy":
        return chunk_aggregate_numpy
    if backend in ("cuda", "cpu"):
        return ChunkAggregator(backend)
    raise ValueError(f"unknown broadcast backend {backend!r}")
