"""Public dispatch for the port's kernels, mirroring ``repro/kernels/ops.py``.

Each op launches its CUDA kernel for CUDA tensors and runs its plain
version (``ref.py``) for CPU tensors.  Under autograd, ``attention``,
``ssd``, ``rms_norm`` and ``rglru_scan`` on CUDA tensors go through their
``torch.autograd.Function`` (forward kernel, backward kernel); on CPU
tensors autograd differentiates the plain versions.  ``meta`` tensors
(the dry-run's planner) take the CUDA route at every branch: shapes only,
each kernel one noted call (``kernels/_build.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.edge_block_spmm import edge_block_spmm
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_grad
from repro_torch.kernels.fused_graduate import fused_graduate
from repro_torch.kernels.rglru_scan import rglru_scan as rglru_scan_kernel
from repro_torch.kernels.rglru_scan import rglru_scan_grad
from repro_torch.kernels.rms_norm import rms_norm as rms_norm_kernel
from repro_torch.kernels.rms_norm import rms_norm_grad
from repro_torch.kernels.ssd_chunk import ssd_scan, ssd_scan_grad


def _wants_grad(*tensors) -> bool:
    """CUDA (or ``meta``) inputs of which autograd will ask a gradient."""
    return (torch.is_grad_enabled() and tensors[0].device.type in _build.CARD_TYPES
            and any(t.requires_grad for t in tensors))


def broadcast_aggregate(feats, src, dst, w, num_dst: int):
    """ATLAS chunk aggregation (segmented reduction). Returns [num_dst, D] f32."""
    return edge_block_spmm(feats, src, dst, w, num_dst)


def graduate(x, w, b, activation: str = "relu"):
    """Fused graduation transform act(x @ w + b)."""
    return fused_graduate(x, w, b, activation)


def attention(q, k, v, causal: bool = True, window: int | None = None):
    """Causal GQA flash attention, [B,Hq,S,D] x [B,Hkv,S,D] -> [B,Hq,S,D],
    with an optional sliding window (query q sees key k iff q - k < window)."""
    if _wants_grad(q, k, v):
        return flash_attention_grad(q, k, v, causal, window)
    return flash_attention(q, k, v, causal, window=window)


def ssd(x, a, b, c, chunk: int = 256, *, heads_per_bc: int = 1, return_state: bool = False):
    """Mamba-2 SSD chunked scan, [BH,S,P] -> [BH,S,P] (and the final
    [BH,P,N] f32 state with ``return_state``)."""
    if _wants_grad(x, a, b, c):
        return ssd_scan_grad(x, a, b, c, chunk, heads_per_bc=heads_per_bc,
                             return_state=return_state)
    return ssd_scan(x, a, b, c, chunk, heads_per_bc=heads_per_bc, return_state=return_state)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x [..., D]``, scale ``[D]``.  ``x``
    may be a strided view (a decode step's ``[B, 1, D]`` slice of a wave's
    embeddings): K5 gets its rows contiguous."""
    d = x.shape[-1]
    rows = x.reshape(-1, d).contiguous()
    if _wants_grad(x, scale):
        return rms_norm_grad(rows, scale, eps).reshape(x.shape)
    return rms_norm_kernel(rows, scale, eps).reshape(x.shape)


def rglru_scan(a, w, h0=None):
    """The RG-LRU recurrence ``h_t = a_t·h_{t-1} + w_t`` over axis 1 of f32
    ``[B, S, R]`` ``a`` and ``w``, from ``h0`` ``[B, R]`` (or 0)."""
    if _wants_grad(a, w, *(() if h0 is None else (h0,))):
        return rglru_scan_grad(a, w, h0)
    return rglru_scan_kernel(a, w, h0)


# re-exported oracles so tests import one module
edge_block_spmm_ref = ref.edge_block_spmm_ref
fused_graduate_ref = ref.fused_graduate_ref
flash_attention_ref = ref.flash_attention_ref
flash_attention_bwd_ref = ref.flash_attention_bwd_ref
ssd_scan_ref = ref.ssd_scan_ref
ssd_scan_bwd_ref = ref.ssd_scan_bwd_ref
rms_norm_ref = ref.rms_norm_ref
rms_norm_bwd_ref = ref.rms_norm_bwd_ref
rglru_scan_ref = ref.rglru_scan_ref
rglru_scan_bwd_ref = ref.rglru_scan_bwd_ref
