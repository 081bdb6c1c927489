"""K6: the RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + w_t``.

No TPU kernel to replace: the reference runs the recurrence with
``jax.lax.associative_scan`` (``repro/models/rglru.py``, ``rglru_scan``)
and XLA differentiates it.  ``csrc/rglru_scan.cu`` runs it as a chunked
scan across blocks in one launch: S is cut into chunks of ``CHUNK`` steps,
one warp per (batch, 32 channels, chunk) forms its chunk's decay product
and local walk, finds the carry into its chunk by a decoupled look-back
over the blocks of the chunks before it (integer tickets and epoch-tagged
words, no float atomics), publishes its own and walks the chunk from its
carry.  Each step is one f32 product then one f32 sum, so the kernel
equals the plain version (``ref.rglru_scan_ref``, which computes the same
chunked order) bitwise, on every run.  It is bound by bytes, 12 per
element.

``rglru_scan_bwd`` is the reverse recurrence, the same kernel walking the
sequence downwards with its own epilogue, bitwise
``ref.rglru_scan_bwd_ref`` (20 bytes per element).  ``rglru_scan_grad`` is
the differentiable op (``torch.autograd.Function``).

``CHUNK`` is one constant, the same on every card and at every S, because
it fixes the bits.  CPU tensors take the plain versions at ``CHUNK`` (so
the card and the CPU agree bit for bit); CUDA tensors launch the kernel or
raise.  ``launches`` and ``bwd_launches`` count the launches.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build

CHUNK = 128  # steps a chunk: of 32, 64 and 128 the fastest on the H100 (PERF.md)

launches = _build.LaunchCount()
bwd_launches = _build.LaunchCount()

_chains: dict[tuple[int, int], list] = {}  # (device, stream) -> [scratch, epoch]
_chains_lock = threading.Lock()


def _check_inputs(name: str, seq: tuple, h0, chunk) -> tuple[int, int, int]:
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
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"{name}: chunk must be a positive int, got {chunk!r}")
    return shape


def _on_card(name: str, tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    tensors on one CUDA device (or on ``meta``); raise otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    device = tensors[0].device
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _chain(device: torch.device, b: int, s: int, r: int, chunk: int):
    """(ticket, chain, epoch) of one launch on ``device``'s current stream:
    one zeroed int64 scratch per (device, stream), grown as needed, whose
    first word holds the kernel's chunk ticket (back at 0 after every
    launch) and the rest the words the blocks publish (each chunk's carry,
    A and H); and this call's epoch, which tags those words so that no
    earlier call's match (1, 2, ..., never 0)."""
    words = 1 + 3 * (-(-s // chunk) - 1) * b * r
    if _build.planned(device):  # the card keeps its zeroed scratch per stream, filled once
        scratch = torch.empty(words, dtype=torch.int64, device=device)
        return scratch, scratch[1:], 1
    stream = torch.cuda.current_stream(device)
    with _chains_lock:
        entry = _chains.setdefault((device.index, stream.cuda_stream), [None, 0])
        if entry[0] is None or entry[0].numel() < words:
            entry[0] = torch.zeros(words, dtype=torch.int64, device=device)
        entry[1] = entry[1] % 0xFFFFFFFF + 1
        scratch, epoch = entry
    return scratch, scratch[1:], epoch


def rglru_scan(a: torch.Tensor, w: torch.Tensor, h0: torch.Tensor | None = None,
               chunk: int = CHUNK) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + w_t`` over axis 1 of f32 ``[B, S, R]`` ``a``
    and ``w``, from ``h0`` (``[B, R]`` f32) or 0, in chunks of ``chunk``
    steps.  Returns ``h`` ``[B, S, R]`` f32."""
    from repro_torch.kernels.ref import rglru_scan_ref  # ref imports CHUNK from here

    b, s, r = _check_inputs("rglru_scan", (a, w), h0, chunk)
    tensors = (a, w) if h0 is None else (a, w, h0)
    if not _on_card("rglru_scan", tensors):
        return rglru_scan_ref(a, w, h0, chunk)
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    ticket, chain, epoch = _chain(a.device, b, s, r, chunk)
    _build.note("rglru_scan", tensors, (h,), chunk=chunk)
    if _build.planned(a.device):
        return h
    lib = _build.load("rglru_scan")
    rc = lib.atlas_rglru_scan(_build.ptr(a), _build.ptr(w),
                              None if h0 is None else _build.ptr(h0), _build.ptr(h),
                              _build.ptr(chain), _build.ptr(ticket), epoch, b, s, r, chunk,
                              _build.stream_handle(a.device))
    _build.check(rc, lib, "rglru_scan")
    launches.add()
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                   h0: torch.Tensor | None = None, chunk: int = CHUNK):
    """``(da, dw, dh0)`` of ``h = rglru_scan(a, w, h0, chunk)`` for the
    gradient ``dh``, from ``a`` and the forward's ``h``; ``dh0`` is None
    without ``h0``."""
    from repro_torch.kernels.ref import rglru_scan_bwd_ref  # ref imports CHUNK from here

    b, s, r = _check_inputs("rglru_scan_bwd", (a, h, dh), h0, chunk)
    tensors = (a, h, dh) if h0 is None else (a, h, dh, h0)
    if not _on_card("rglru_scan_bwd", tensors):
        return rglru_scan_bwd_ref(a, h, dh, h0, chunk)
    da, dw = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0:
        return da, dw, None if dh0 is None else dh0.zero_()
    ticket, chain, epoch = _chain(a.device, b, s, r, chunk)
    _build.note("rglru_scan_bwd", tensors, (da, dw) if dh0 is None else (da, dw, dh0),
                chunk=chunk)
    if _build.planned(a.device):
        return da, dw, dh0
    lib = _build.load("rglru_scan")
    rc = lib.atlas_rglru_scan_bwd(*(_build.ptr(t) for t in (a, h, dh)),
                                  None if h0 is None else _build.ptr(h0),
                                  _build.ptr(da), _build.ptr(dw),
                                  None if dh0 is None else _build.ptr(dh0),
                                  _build.ptr(chain), _build.ptr(ticket), epoch, b, s, r, chunk,
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
