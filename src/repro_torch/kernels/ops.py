"""Public dispatch for the port's kernels, mirroring ``repro/kernels/ops.py``.

Each op launches its CUDA kernel for CUDA tensors and runs its plain
version (``ref.py``) for CPU tensors.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.edge_block_spmm import edge_block_spmm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_graduate import fused_graduate
from repro_torch.kernels.rms_norm import rms_norm as rms_norm_kernel
from repro_torch.kernels.ssd_chunk import ssd_scan


def broadcast_aggregate(feats, src, dst, w, num_dst: int):
    """ATLAS chunk aggregation (segmented reduction). Returns [num_dst, D] f32."""
    return edge_block_spmm(feats, src, dst, w, num_dst)


def graduate(x, w, b, activation: str = "relu"):
    """Fused graduation transform act(x @ w + b)."""
    return fused_graduate(x, w, b, activation)


def attention(q, k, v, causal: bool = True):
    """Causal GQA flash attention, [B,Hq,S,D] x [B,Hkv,S,D] -> [B,Hq,S,D]."""
    return flash_attention(q, k, v, causal)


def ssd(x, a, b, c, chunk: int = 256, *, heads_per_bc: int = 1, return_state: bool = False):
    """Mamba-2 SSD chunked scan, [BH,S,P] -> [BH,S,P] (and the final
    [BH,P,N] f32 state with ``return_state``)."""
    return ssd_scan(x, a, b, c, chunk, heads_per_bc=heads_per_bc, return_state=return_state)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x [..., D]``, scale ``[D]``."""
    d = x.shape[-1]
    return rms_norm_kernel(x.reshape(-1, d), scale, eps).reshape(x.shape)


# re-exported oracles so tests import one module
edge_block_spmm_ref = ref.edge_block_spmm_ref
fused_graduate_ref = ref.fused_graduate_ref
flash_attention_ref = ref.flash_attention_ref
ssd_scan_ref = ref.ssd_scan_ref
rms_norm_ref = ref.rms_norm_ref
