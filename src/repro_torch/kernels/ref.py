"""Plain PyTorch versions of the port's kernels.

Each ``*_ref`` computes what its kernel computes, with torch ops, on any
device: the wrappers run it for CPU tensors, the CPU tests hold it against
the JAX package, and ``chip_smoke.py`` holds each kernel against it on the
card.  Mirrors ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def segment_reduce_sorted_ref(
    feats: torch.Tensor,  # [n, D] f32 or bf16
    src: torch.Tensor,  # [m] int, edges grouped by segment
    w: torch.Tensor,  # [m] f32
    seg_offsets: torch.Tensor,  # [s + 1] int, offsets[0] = 0, offsets[s] = m
) -> torch.Tensor:
    """``out[s] = Σ_{e ∈ [off[s], off[s+1])} w[e]·feats[src[e]]`` in f32;
    edges whose source lies outside ``[0, n)`` add nothing."""
    n, d = feats.shape
    num_seg = seg_offsets.numel() - 1
    counts = (seg_offsets[1:] - seg_offsets[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_seg, device=feats.device), counts
    )
    src = src.long()
    valid = (src >= 0) & (src < n)
    out = torch.zeros((num_seg, d), dtype=torch.float32, device=feats.device)
    if n == 0 or not bool(valid.any()):
        return out
    msgs = feats[src.clamp(0, n - 1)].float() * w.float()[:, None]
    msgs = torch.where(valid[:, None], msgs, torch.zeros((), device=feats.device))
    return out.index_add_(0, seg, msgs)


def edge_block_spmm_ref(
    feats: torch.Tensor,  # [V_src, D]
    src: torch.Tensor,  # [E] int, indices into feats rows
    dst: torch.Tensor,  # [E] int, indices into output rows
    w: torch.Tensor,  # [E] float
    num_dst: int,
) -> torch.Tensor:
    """``out[dst[e]] += w[e]·feats[src[e]]`` as ``[num_dst, D]`` f32.
    Edges with a source or destination out of range (the ``-1`` padding
    sentinel) add nothing, as in the TPU kernel."""
    n, d = feats.shape
    src, dst = src.long(), dst.long()
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < num_dst)
    src, dst, w = src[keep], dst[keep], w[keep]
    msgs = feats[src].float() * w.float()[:, None]
    out = torch.zeros((num_dst, d), dtype=torch.float32, device=feats.device)
    return out.index_add_(0, dst, msgs)


def fused_graduate_ref(
    x: torch.Tensor,  # [N, K]
    w: torch.Tensor,  # [K, M]
    b: torch.Tensor,  # [M]
    activation: str = "relu",
) -> torch.Tensor:
    """``act(x @ w + b)`` accumulated in f32, returned in ``x.dtype``;
    gelu is the tanh approximation (``jax.nn.gelu``'s default)."""
    out = x.float() @ w.float() + b.float()
    if activation == "relu":
        out = torch.relu(out)
    elif activation == "gelu":
        out = F.gelu(out, approximate="tanh")
    elif activation != "none":
        raise ValueError(activation)
    return out.to(x.dtype)
