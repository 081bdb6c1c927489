"""K1: chunk aggregation, ``out[dst[e]] += w[e]·feats[src[e]]``.

Replaces the TPU kernel ``_spmm_kernel`` (``repro/kernels/edge_block_spmm.py``).
The CUDA kernels (``csrc/edge_block_spmm.cu``) are a deterministic
segmented reduction over edges grouped by destination; they are bound by
memory bandwidth.  Two routes, picked by ``route`` from the dtype, the
width and the alignment, never by trying one and catching:

- ``"rows"``: f32 or bf16 rows with ``d % 4 == 0``, ``d <= ROWS_MAX_D``,
  feats and out 16-byte aligned (every width of the GNN path): a warp
  owns whole output rows, reads a segment's indices once, keeps four
  edges' row loads in flight across segment boundaries and streams its
  output past L2; segments of more than 64 edges (power-law hubs) go to
  a second pass that spreads their column slices over the warps, and
  those of more than ``slab_edges()`` edges to a second launch that
  spreads their slabs over the warps.
- ``"general"``: every other width and unaligned views: a warp per
  (segment, 128-column tile), one edge after another.

The order of the sum, the same in both, so they agree bit for bit: a
segment is cut into slabs of L = ``slab_edges()`` (2048) consecutive
edges counted from its first edge, the last slab holding what remains;
each slab sums in f32 in edge order from 0, and the row is slab 0's
partial with the others added in slab order.  L is one constant of the
kernel source (``kSlabEdges``), so the bits depend on a segment's length
alone, never on the card or the grid; a segment of at most L edges is one
slab, the single chain in edge order from 0 that K1 summed before the
slabs.  The rows route's scratch (``torch.empty``, sized from m and d on
the host: the f32 partials of at most 2m / (L + 1) slabs and their
records, 12.6 MiB at m = 13 M, d = 256) lives for one call; no float
atomics.  Two entry
points:

* ``segment_reduce_sorted`` — the engine's entry: edges already grouped by
  destination, one output row per segment.
* ``edge_block_spmm`` — the same signature as the JAX package's, for any
  edge order; it groups the edges with a stable sort, then reduces.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
route's kernel or raise.  ``launches`` counts every call that launches,
``rows_launches`` and ``general_launches`` (``route_launches[route]``)
each route's; ``split_counts`` the segments the rows route split into
slabs and their slabs, on the card.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import edge_block_spmm_ref, segment_reduce_sorted_ref

launches = _build.LaunchCount()
rows_launches = _build.LaunchCount()
general_launches = _build.LaunchCount()
route_launches = {"rows": rows_launches, "general": general_launches}


class SplitCounts:
    """The rows route's split, counted on the card by integer atomics:
    segments of more than ``slab_edges()`` edges split into slabs, and the
    slabs summed.  One ``[2]`` int64 counter per device, which the kernel
    adds to; ``value`` reads them (one copy a device, after its work has
    finished) and ``reset`` zeroes them, as ``LaunchCount`` does.  Nothing
    on a timed path reads them."""

    def __init__(self) -> None:
        self._counts: dict[int, torch.Tensor] = {}
        self._lock = threading.Lock()

    def counter(self, device: torch.device) -> torch.Tensor:
        """The counter the kernel on ``device`` adds to."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        with self._lock:
            if index not in self._counts:
                self._counts[index] = torch.zeros(2, dtype=torch.int64,
                                                  device=torch.device("cuda", index))
            return self._counts[index]

    @property
    def value(self) -> tuple[int, int]:
        """(segments split, slabs summed) over every device since the last
        ``reset``."""
        with self._lock:
            counts = list(self._counts.values())
        total = [0, 0]
        for c in counts:
            torch.cuda.synchronize(c.device)
            total = [t + v for t, v in zip(total, c.tolist())]
        return total[0], total[1]

    def reset(self) -> None:
        with self._lock:
            for c in self._counts.values():
                c.zero_()


split_counts = SplitCounts()

_FEAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
ROWS_MAX_D = 512  # widest row the "rows" kernel holds in registers


def slab_edges() -> int:
    """L, the edges of a slab, as the built kernel has it (loads the
    library: needs the card's toolkit)."""
    return _build.load("edge_block_spmm").atlas_segment_slab_edges()


def route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"rows"`` for f32 or bf16 rows of a
    multiple of 4 values, at most ``ROWS_MAX_D``, with feats and out
    16-byte aligned; else ``"general"``."""
    if dtype in _FEAT_DTYPES and 0 < d <= ROWS_MAX_D and d % 4 == 0 and aligned:
        return "rows"
    return "general"


def segment_reduce_sorted(
    feats: torch.Tensor,  # [n, D] f32 or bf16
    src_sorted: torch.Tensor,  # [m] int32, grouped by destination segment
    w_sorted: torch.Tensor,  # [m] f32
    seg_offsets: torch.Tensor,  # [s + 1] int32, offsets[0] = 0, offsets[s] = m
) -> torch.Tensor:
    """``[s, D]`` f32: row ``i`` sums ``w·feats[src]`` over the edges
    ``[offsets[i], offsets[i+1])`` in their given order.  Empty segments
    give zero rows; sources outside ``[0, n)`` add nothing."""
    if feats.dim() != 2:
        raise ValueError(f"feats must be [n, D], got {tuple(feats.shape)}")
    if feats.dtype not in _FEAT_DTYPES:
        raise TypeError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    if src_sorted.dim() != 1 or w_sorted.shape != src_sorted.shape:
        raise ValueError("src_sorted and w_sorted must be [m] vectors of one length")
    if seg_offsets.dim() != 1 or seg_offsets.numel() < 1:
        raise ValueError("seg_offsets must be a [s + 1] vector")
    if src_sorted.dtype != torch.int32 or seg_offsets.dtype != torch.int32:
        raise TypeError("src_sorted and seg_offsets must be int32")
    if w_sorted.dtype != torch.float32:
        raise TypeError(f"w_sorted must be float32, got {w_sorted.dtype}")
    n, d = feats.shape
    m = src_sorted.numel()
    if n > _INT32_MAX or m > _INT32_MAX:
        raise ValueError(f"n={n} and m={m} must be below 2**31 (int32 indices)")
    tensors = (feats, src_sorted, w_sorted, seg_offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return segment_reduce_sorted_ref(feats, src_sorted, w_sorted, seg_offsets)
    device = feats.device
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError("segment_reduce_sorted: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segment_reduce_sorted: tensors must be contiguous")
    num_seg = seg_offsets.numel() - 1
    if m == 0:
        return torch.zeros((num_seg, d), dtype=torch.float32, device=device)
    out = torch.empty((num_seg, d), dtype=torch.float32, device=device)
    if num_seg == 0 or d == 0:
        return out
    _build.note("edge_block_spmm", tensors, (out,))
    if _build.planned(device):
        return out
    lib = _build.load("edge_block_spmm")
    path = route(feats.dtype, d, feats.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    operands = (_build.ptr(feats), _FEAT_DTYPES[feats.dtype], _build.ptr(src_sorted),
                _build.ptr(w_sorted), _build.ptr(seg_offsets), _build.ptr(out))
    shape = (num_seg, n, m, d, _build.stream_handle(device))
    if path == "rows":
        scratch = torch.empty(lib.atlas_segment_rows_scratch_bytes(m, d) // 4,
                              dtype=torch.float32, device=device)
        rc = lib.atlas_segment_rows(*operands, _build.ptr(scratch),
                                    _build.ptr(split_counts.counter(device)), *shape)
    else:
        rc = lib.atlas_segment_reduce(*operands, *shape)
    _build.check(rc, lib, "edge_block_spmm")
    launches.add()
    route_launches[path].add()
    return out


def edge_block_spmm(
    feats: torch.Tensor,  # [V_src, D] f32 or bf16
    src: torch.Tensor,  # [E] int
    dst: torch.Tensor,  # [E] int
    w: torch.Tensor,  # [E] float32
    num_dst: int,
) -> torch.Tensor:
    """Returns ``[num_dst, D]`` f32: segment-sum of w-scaled source rows.
    Edges whose source or destination is out of range (the ``-1``
    padding sentinel) add nothing; ``E == 0`` returns zeros without a
    launch."""
    d = feats.shape[1]
    if src.numel() == 0:
        return torch.zeros((num_dst, d), dtype=torch.float32, device=feats.device)
    if feats.device.type == "cpu":
        return edge_block_spmm_ref(feats, src, dst, w, num_dst)
    dst = dst.long()
    keep = (dst >= 0) & (dst < num_dst)
    # stable sort by destination; dropped edges sort past offsets[-1]
    order = torch.argsort(torch.where(keep, dst, num_dst), stable=True)
    if _build.planned(feats.device):  # the counts' length is data on the card, num_dst here
        counts = torch.empty(num_dst, dtype=torch.int64, device=feats.device)
    else:
        counts = torch.bincount(dst[keep], minlength=num_dst)
    offsets = torch.zeros(num_dst + 1, dtype=torch.int32, device=feats.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return segment_reduce_sorted(
        feats.contiguous(),
        src.to(torch.int32)[order].contiguous(),
        w.to(torch.float32)[order].contiguous(),
        offsets,
    )
