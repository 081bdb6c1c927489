"""K2: the graduation transform ``act(x @ W + b)``.

Replaces the TPU kernel ``_graduate_kernel`` (``repro/kernels/fused_graduate.py``).
Two routes in ``csrc/fused_graduate.cu``, picked by ``route`` from the
dtype, the shape and the alignment, never by trying one and catching:

- ``"tensor_core"``: bf16 with ``k % 8 == 0`` (k > 0) and ``m % 8 == 0`` on
  16-byte aligned x and W (TMA's rule for strides and addresses): wgmma
  on 128x128 tiles fed by TMA through a four-stage mbarrier ring.
- ``"cuda_core"``: everything else, f32 above all (the GNN main path; TF32
  stays off): a register-blocked, cp.async-pipelined SGEMM with 8x8
  outputs per thread, reading bf16 or f32.

Both accumulate in f32 in a fixed order and fuse bias and activation.
At the main path's shapes the kernel is bound by operations.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
route's kernel or raise.  ``launches`` counts every launch,
``tensor_core_launches`` and ``cuda_core_launches`` (``route_launches[route]``)
each route's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_graduate_ref

launches = _build.LaunchCount()
tensor_core_launches = _build.LaunchCount()
cuda_core_launches = _build.LaunchCount()
route_launches = {"tensor_core": tensor_core_launches, "cuda_core": cuda_core_launches}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "relu": 1, "gelu": 2}
_MAX_GRID_Y = 65535  # the kernels put column tiles of 128 on y


def route(dtype: torch.dtype, k: int, m: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"tensor_core"`` for bf16 with
    ``k % 8 == 0`` (k > 0), ``m % 8 == 0`` and 16-byte aligned x and W,
    else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and m % 8 == 0 and aligned:
        return "tensor_core"
    return "cuda_core"


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
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError("fused_graduate: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_graduate: tensors must be contiguous")
    if max(n, k, m) > 2**31 - 1 or -(-m // 128) > _MAX_GRID_Y:
        raise ValueError("fused_graduate: dimensions too large")
    out = torch.empty((n, m), dtype=x.dtype, device=device)
    if n == 0 or m == 0:
        return out
    _build.note("fused_graduate", tensors, (out,), activation=activation)
    if _build.planned(device):
        return out
    lib = _build.load("fused_graduate")
    args = (_build.ptr(x), _build.ptr(w), _build.ptr(b), _build.ptr(out), n, k, m)
    stream = _build.stream_handle(device)
    path = route(x.dtype, k, m, aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if path == "tensor_core":
        rc = lib.atlas_fused_graduate_tc(*args, _ACTS[activation], stream)
    else:
        rc = lib.atlas_fused_graduate(*args, _DTYPES[x.dtype], _ACTS[activation], stream)
    _build.check(rc, lib, "fused_graduate")
    launches.add()
    route_launches[path].add()
    return out
