"""K5: RMSNorm ``x·rsqrt(mean(x²) + eps)·(1 + scale)`` over the last axis.

Replaces the TPU kernel ``_rms_kernel`` (``repro/kernels/rms_norm.py``).
It is bound by bytes: each value is read once from HBM and written once.
Two routes in ``csrc/rms_norm.cu``, picked by ``route`` from the dtype,
the width and the alignment, never by trying one and catching:

- ``"resident"``: the served widths (128, 2560, 5120) in bf16 or f32 on
  16-byte aligned tensors: every thread of a row holds the same whole
  number of 16-byte packs in registers between the sum of squares and
  the scaling, ``scale`` is loaded once per block, and a grid sized to the
  card walks the rows with the next row's loads in flight.
- ``"general"``: every other width and unaligned views: a warp (rows of
  at most 1024 values) or a block per row, 16-byte loads where the width
  and the pointers allow, a second pass over the row for the scaling.

Both sum the squares in f32 in one fixed order.  CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the route's kernel or
raise.  ``launches`` counts every launch, ``resident_launches`` and
``general_launches`` (``route_launches[route]``) each route's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rms_norm_ref

launches = _build.LaunchCount()
resident_launches = _build.LaunchCount()
general_launches = _build.LaunchCount()
route_launches = {"resident": resident_launches, "general": general_launches}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RESIDENT_WIDTHS = (128, 2560, 5120)  # qk-norm, mamba2-2.7b's d_model, qwen3's and mamba's inner


def route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"resident"`` for f32 or bf16 rows of
    128, 2560 or 5120 values on 16-byte aligned x, scale and out, else
    ``"general"``."""
    if dtype in _DTYPES and d in _RESIDENT_WIDTHS and aligned:
        return "resident"
    return "general"


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
    lib = _build.load("rms_norm")
    stream = _build.stream_handle(device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    path = route(x.dtype, d, aligned)
    if path == "resident":
        rc = lib.atlas_rms_norm_resident(
            _build.ptr(x), _build.ptr(scale), _build.ptr(out), n, d, eps, _DTYPES[x.dtype], stream,
        )
    else:
        vec = 16 // x.element_size() if d % (16 // x.element_size()) == 0 and aligned else 1
        rc = lib.atlas_rms_norm(
            _build.ptr(x), _build.ptr(scale), _build.ptr(out), n, d, eps,
            _DTYPES[x.dtype], vec, stream,
        )
    _build.check(rc, lib, "rms_norm")
    launches.add()
    route_launches[path].add()
    return out
