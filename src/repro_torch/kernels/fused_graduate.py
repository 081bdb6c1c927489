"""K2: the graduation transform ``act(x @ W + b)``.

Replaces the TPU kernel ``_graduate_kernel`` (``repro/kernels/fused_graduate.py``).
The CUDA kernel (``csrc/fused_graduate.cu``) is a tiled shared-memory GEMM
with f32 accumulation and a fused bias and activation epilogue; at the
main path's shapes it is bound by operations.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_graduate_ref

launches = _build.LaunchCount()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "relu": 1, "gelu": 2}


def fused_graduate(
    x: torch.Tensor,  # [N, K] finalized aggregate rows
    w: torch.Tensor,  # [K, M] layer weight
    b: torch.Tensor,  # [M] bias
    activation: str = "relu",  # 'none' | 'relu' | 'gelu' (tanh)
) -> torch.Tensor:
    """``act(x @ w + b)`` accumulated in f32, returned in ``x.dtype``."""
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("fused_graduate wants x [N, K], w [K, M], b [M]")
    n, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}"
        )
    m = w.shape[1]
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            f"x, w, b must share float32 or bfloat16, got {x.dtype}, {w.dtype}, {b.dtype}"
        )
    tensors = (x, w, b)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_graduate_ref(x, w, b, activation)
    device = x.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("fused_graduate: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_graduate: tensors must be contiguous")
    if max(n, k, m) > 2**31 - 1:
        raise ValueError("fused_graduate: dimensions must be below 2**31")
    out = torch.empty((n, m), dtype=x.dtype, device=device)
    if n == 0 or m == 0:
        return out
    lib = _build.load("fused_graduate")
    rc = lib.atlas_fused_graduate(
        _build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(out),
        n, k, m, _DTYPES[x.dtype], _ACTS[activation], _build.stream_handle(device),
    )
    _build.check(rc, lib, "fused_graduate")
    launches.add()
    return out
