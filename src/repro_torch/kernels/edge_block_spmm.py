"""K1: chunk aggregation, ``out[dst[e]] += w[e]·feats[src[e]]``.

Replaces the TPU kernel ``_spmm_kernel`` (``repro/kernels/edge_block_spmm.py``).
The CUDA kernel (``csrc/edge_block_spmm.cu``) is a deterministic segmented
reduction over edges grouped by destination; it is bound by memory
bandwidth.  Two entry points:

* ``segment_reduce_sorted`` — the engine's entry: edges already grouped by
  destination, one output row per segment.
* ``edge_block_spmm`` — the same signature as the JAX package's, for any
  edge order; it groups the edges with a stable sort, then reduces.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import edge_block_spmm_ref, segment_reduce_sorted_ref

launches = _build.LaunchCount()

_FEAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


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
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("segment_reduce_sorted: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segment_reduce_sorted: tensors must be contiguous")
    num_seg = seg_offsets.numel() - 1
    if m == 0:
        return torch.zeros((num_seg, d), dtype=torch.float32, device=device)
    out = torch.empty((num_seg, d), dtype=torch.float32, device=device)
    if num_seg == 0 or d == 0:
        return out
    lib = _build.load("edge_block_spmm")
    rc = lib.atlas_segment_reduce(
        _build.ptr(feats), _FEAT_DTYPES[feats.dtype], _build.ptr(src_sorted),
        _build.ptr(w_sorted), _build.ptr(seg_offsets), _build.ptr(out),
        num_seg, n, m, d, _build.stream_handle(device),
    )
    _build.check(rc, lib, "edge_block_spmm")
    launches.add()
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
    counts = torch.bincount(dst[keep], minlength=num_dst)
    offsets = torch.zeros(num_dst + 1, dtype=torch.int32, device=feats.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return segment_reduce_sorted(
        feats.contiguous(),
        src.to(torch.int32)[order].contiguous(),
        w.to(torch.float32)[order].contiguous(),
        offsets,
    )
