"""K5: RMSNorm ``x·rsqrt(mean(x²) + eps)·(1 + scale)`` over the last axis.

Replaces the TPU kernel ``_rms_kernel`` (``repro/kernels/rms_norm.py``).
The CUDA kernel (``csrc/rms_norm.cu``) gives each row to one warp (rows of
at most 1024 values) or one block (wider rows), reads it with 16-byte
loads, sums the squares in f32 in a fixed order and scales in a second
pass over the row.  It is bound by bytes: each value is read once from
HBM and written once.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rms_norm_ref

launches = _build.LaunchCount()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x [N, D]``, ``scale [D]`` in one dtype (f32 or bf16); f32 math,
    the result in ``x.dtype``."""
    if x.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(
            f"rms_norm wants x [N, D] and scale [D], got {tuple(x.shape)}, {tuple(scale.shape)}"
        )
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"x and scale must share float32 or bfloat16, got {x.dtype}, {scale.dtype}")
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rms_norm_ref(x, scale, eps)
    device = x.device
    if device.type != "cuda" or scale.device != device:
        raise ValueError("rms_norm: x and scale on one CUDA device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rms_norm: tensors must be contiguous")
    n, d = x.shape
    if n > 2**31 - 1 or d > 2**31 - 1:
        raise ValueError(f"rms_norm: [{n}, {d}] is too large")
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    vec = 16 // x.element_size()
    if d % vec or any(t.data_ptr() % 16 for t in (x, scale, out)):
        vec = 1
    lib = _build.load("rms_norm")
    rc = lib.atlas_rms_norm(
        _build.ptr(x), _build.ptr(scale), _build.ptr(out), n, d, eps,
        _DTYPES[x.dtype], vec, _build.stream_handle(device),
    )
    _build.check(rc, lib, "rms_norm")
    launches.add()
    return out
