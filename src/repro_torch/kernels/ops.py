"""Public dispatch for the port's kernels, mirroring ``repro/kernels/ops.py``.

Each op launches its CUDA kernel for CUDA tensors and runs its plain
version (``ref.py``) for CPU tensors.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.edge_block_spmm import edge_block_spmm
from repro_torch.kernels.fused_graduate import fused_graduate


def broadcast_aggregate(feats, src, dst, w, num_dst: int):
    """ATLAS chunk aggregation (segmented reduction). Returns [num_dst, D] f32."""
    return edge_block_spmm(feats, src, dst, w, num_dst)


def graduate(x, w, b, activation: str = "relu"):
    """Fused graduation transform act(x @ w + b)."""
    return fused_graduate(x, w, b, activation)


# re-exported oracles so tests import one module
edge_block_spmm_ref = ref.edge_block_spmm_ref
fused_graduate_ref = ref.fused_graduate_ref
