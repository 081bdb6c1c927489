"""K5: RMSNorm ``x·rsqrt(mean(x²) + eps)·(1 + scale)`` over the last axis.

Replaces the TPU kernel ``_rms_kernel`` (``repro/kernels/rms_norm.py``).
It is bound by bytes: each value is read once from HBM and written once.
Two routes in ``csrc/rms_norm.cu``, picked by ``route`` from the dtype,
the width and the alignment, never by trying one and catching:

- ``"resident"``: the served and trained widths (128, 2048, 2560, 3584,
  4096, 5120, 7168) in bf16 or f32 on 16-byte aligned tensors: every
  thread of a row holds the same whole number of 16-byte packs in
  registers between the sum of squares and the scaling, ``scale`` is
  loaded once per block, and a grid sized to the card walks the rows with
  the next row's loads in flight.
- ``"general"``: every other width (musicgen's 1536, starcoder2's 3072)
  and unaligned views: a warp (rows of at most 1024 values) or a block per
  row, 16-byte loads where the width and the pointers allow, a second
  pass over the row for the scaling.

Both sum the squares in f32 in one fixed order.  CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the route's kernel or
raise.  ``launches`` counts every launch, ``resident_launches`` and
``general_launches`` (``route_launches[route]``) each route's.

``rms_norm_bwd`` is the gradient (no Pallas counterpart: the reference
leaves it to XLA).  It takes the forward's two routes under the same rule
(``bwd_route``), each a kernel over the rows into per-block partial sums
of ``dscale`` over a fixed grid (two blocks per SM), then a kernel that
adds them in a fixed order (block order; on the resident route, runs of
consecutive blocks in block order, then the runs in order): no float
atomics.

- ``"resident"`` (the resident widths, 16-byte aligned): x and dy read
  once as 16-byte packs held in registers, both row sums up one shuffle
  tree, dx written from the registers, each thread's ``dy·x·r`` summed in
  registers for its fixed columns and written once per block.
- ``"general"``: two passes over the row, ``dscale`` summed in a
  shared-memory slice per row slot.

``bwd_launches`` counts every call, ``bwd_resident_launches`` and
``bwd_general_launches`` (``bwd_route_launches[route]``) each route's.
``rms_norm_grad`` is the differentiable op (``torch.autograd.Function``)
whose forward is ``rms_norm`` and whose backward is ``rms_norm_bwd``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rms_norm_bwd_ref, rms_norm_ref

launches = _build.LaunchCount()
bwd_launches = _build.LaunchCount()
resident_launches = _build.LaunchCount()
general_launches = _build.LaunchCount()
route_launches = {"resident": resident_launches, "general": general_launches}
bwd_resident_launches = _build.LaunchCount()
bwd_general_launches = _build.LaunchCount()
bwd_route_launches = {"resident": bwd_resident_launches, "general": bwd_general_launches}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# qk-norm, deepseek-moe-16b's d_model, mamba2-2.7b's d_model, qwen2-7b's d_model,
# recurrentgemma-9b's d_model, qwen3's d_model and mamba's inner, arctic-480b's d_model
_RESIDENT_WIDTHS = (128, 2048, 2560, 3584, 4096, 5120, 7168)
_SMEM_BYTES = 227 * 1024  # shared memory a block may use on Hopper
_BLOCKS_PER_SM = 2  # the backward's grid: fixed per card, so dscale's sum order is too


def route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"resident"`` for f32 or bf16 rows of
    128, 2048, 2560, 3584, 4096, 5120 or 7168 values on 16-byte aligned x,
    scale and out, else ``"general"``."""
    if dtype in _DTYPES and d in _RESIDENT_WIDTHS and aligned:
        return "resident"
    return "general"


def bwd_route(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor) -> str:
    """The backward kernel a CUDA call of ``rms_norm_bwd`` takes: the
    forward's rule (``route``) on x's dtype and width, so the same seven
    widths, aligned when x, scale and dy start on 16 bytes (dx is a fresh
    allocation)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, dy))
    return route(x.dtype, x.shape[-1], aligned)


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
    if device.type not in _build.CARD_TYPES or scale.device != device:
        raise ValueError("rms_norm: x and scale on one CUDA device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rms_norm: tensors must be contiguous")
    n, d = x.shape
    if n > 2**31 - 1 or d > 2**31 - 1:
        raise ValueError(f"rms_norm: [{n}, {d}] is too large")
    out = torch.empty_like(x)
    if n == 0 or d == 0:
        return out
    _build.note("rms_norm", (x, scale), (out,))
    if _build.planned(device):
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


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """``(dx, dscale)`` of ``rms_norm(x, scale, eps)`` for the output
    gradient ``dy [N, D]``; f32 math, ``dx`` in ``x.dtype`` and ``dscale``
    in ``scale.dtype``.  On the card (route by ``bwd_route``): one kernel
    over the rows into per-block partial sums of ``dscale`` (a fixed grid
    of two blocks per SM), then one that adds them in a fixed order: no
    float atomics."""
    if x.dim() != 2 or dy.shape != x.shape or scale.dim() != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(
            f"rms_norm_bwd wants x, dy [N, D] and scale [D], got {tuple(x.shape)}, "
            f"{tuple(dy.shape)}, {tuple(scale.shape)}"
        )
    if x.dtype not in _DTYPES or scale.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"x, scale and dy must share float32 or bfloat16, got "
                        f"{x.dtype}, {scale.dtype}, {dy.dtype}")
    tensors = (x, scale, dy)
    if all(t.device.type == "cpu" for t in tensors):
        return rms_norm_bwd_ref(x, scale, dy, eps)
    device = x.device
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError("rms_norm_bwd: x, scale and dy on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rms_norm_bwd: tensors must be contiguous")
    n, d = x.shape
    path = bwd_route(x, scale, dy)
    rows_per_block = 8 if d <= 1024 else 1  # the general route: a warp or a block per row
    if n > 2**31 - 1 or (path == "general" and d * 4 * rows_per_block > _SMEM_BYTES):
        raise ValueError(f"rms_norm_bwd: [{n}, {d}] is too large")
    dx = torch.empty_like(x)
    if n == 0 or d == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    cap = _BLOCKS_PER_SM * _build.sm_count(device)
    blocks = min(n, cap) if path == "resident" else min(-(-n // rows_per_block), cap)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=device)
    _build.note("rms_norm_bwd", tensors, (dx, dscale))
    if _build.planned(device):
        return dx, dscale
    lib = _build.load("rms_norm")
    stream = _build.stream_handle(device)
    if path == "resident":
        rc = lib.atlas_rms_norm_bwd_resident(
            *(_build.ptr(t) for t in (x, scale, dy, dx, dscale, partial)),
            n, d, blocks, eps, _DTYPES[x.dtype], stream,
        )
    else:
        per = 16 // x.element_size()
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, dy, dx))
        rc = lib.atlas_rms_norm_bwd(
            *(_build.ptr(t) for t in (x, scale, dy, dx, dscale, partial)),
            n, d, blocks, eps, _DTYPES[x.dtype], per if d % per == 0 and aligned else 1, stream,
        )
    _build.check(rc, lib, "rms_norm")
    bwd_launches.add()
    bwd_route_launches[path].add()
    return dx, dscale


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rms_norm_grad(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` that autograd differentiates through ``rms_norm_bwd``."""
    return _RmsNorm.apply(x, scale, eps)
