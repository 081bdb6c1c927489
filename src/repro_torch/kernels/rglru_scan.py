"""K6: the RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + w_t``.

No TPU kernel to replace: the reference runs the recurrence with
``jax.lax.associative_scan`` (``repro/models/rglru.py``, ``rglru_scan``)
and XLA differentiates it.  ``csrc/rglru_scan.cu`` runs one thread per
(batch, channel) that walks the sequence with its state in a register and
the next steps' loads in flight; each step is one f32 product then one f32
sum, so the kernel equals the plain loop (``ref.rglru_scan_ref``) bitwise.
It is bound by bytes (12 per element), and by memory latency at the
served and trained shapes, where only B·R threads run.

``rglru_scan_bwd`` is the reverse recurrence, the same design walking the
sequence downwards, bitwise ``ref.rglru_scan_bwd_ref``.  ``rglru_scan_grad``
is the differentiable op (``torch.autograd.Function``).

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise.  ``launches`` and ``bwd_launches`` count the launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

launches = _build.LaunchCount()
bwd_launches = _build.LaunchCount()

_MAX_BATCH = 65535  # the kernel's grid puts the batch on y


def _check_inputs(name: str, seq: tuple, h0) -> tuple[int, int, int]:
    """(B, S, R) of ``seq``'s [B, S, R] f32 tensors and ``h0`` (None or
    [B, R] f32), or raise."""
    shape = seq[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in seq):
        raise ValueError(f"{name}: want [B, S, R] tensors of one shape, got "
                         f"{[tuple(t.shape) for t in seq]}")
    if h0 is not None and h0.shape != (shape[0], shape[2]):
        raise ValueError(f"{name}: h0 must be [{shape[0]}, {shape[2]}], got {tuple(h0.shape)}")
    tensors = (*seq, *(() if h0 is None else (h0,)))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: tensors must be float32, got {[t.dtype for t in tensors]}")
    return shape


def _on_card(name: str, tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    tensors on one CUDA device; raise otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def rglru_scan(a: torch.Tensor, w: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + w_t`` over axis 1 of f32 ``[B, S, R]`` ``a``
    and ``w``, from ``h0`` (``[B, R]`` f32) or 0.  Returns ``h``
    ``[B, S, R]`` f32."""
    b, s, r = _check_inputs("rglru_scan", (a, w), h0)
    tensors = (a, w) if h0 is None else (a, w, h0)
    if not _on_card("rglru_scan", tensors):
        return rglru_scan_ref(a, w, h0)
    if b > _MAX_BATCH:
        raise ValueError(f"rglru_scan: batch {b} above {_MAX_BATCH}")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _build.load("rglru_scan")
    rc = lib.atlas_rglru_scan(_build.ptr(a), _build.ptr(w),
                              None if h0 is None else _build.ptr(h0), _build.ptr(h), b, s, r,
                              _build.stream_handle(a.device))
    _build.check(rc, lib, "rglru_scan")
    launches.add()
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                   h0: torch.Tensor | None = None):
    """``(da, dw, dh0)`` of ``h = rglru_scan(a, w, h0)`` for the gradient
    ``dh``, from ``a`` and the forward's ``h``; ``dh0`` is None without
    ``h0``."""
    b, s, r = _check_inputs("rglru_scan_bwd", (a, h, dh), h0)
    tensors = (a, h, dh) if h0 is None else (a, h, dh, h0)
    if not _on_card("rglru_scan_bwd", tensors):
        return rglru_scan_bwd_ref(a, h, dh, h0)
    if b > _MAX_BATCH:
        raise ValueError(f"rglru_scan_bwd: batch {b} above {_MAX_BATCH}")
    da, dw = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0:
        return da, dw, None if dh0 is None else dh0.zero_()
    lib = _build.load("rglru_scan")
    rc = lib.atlas_rglru_scan_bwd(*(_build.ptr(t) for t in (a, h, dh)),
                                  None if h0 is None else _build.ptr(h0),
                                  _build.ptr(da), _build.ptr(dw),
                                  None if dh0 is None else _build.ptr(dh0), b, s, r,
                                  _build.stream_handle(a.device))
    _build.check(rc, lib, "rglru_scan")
    bwd_launches.add()
    return da, dw, dh0


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, h0):
        h = rglru_scan(a, w, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        da, dw, dh0 = rglru_scan_bwd(a, h, dh.contiguous(), h0)
        return da, dw, dh0


def rglru_scan_grad(a: torch.Tensor, w: torch.Tensor,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """``rglru_scan`` on CUDA tensors that autograd differentiates through
    ``rglru_scan_bwd``."""
    return _RGLRUScan.apply(a, w, h0)
