"""K4: the Mamba-2 SSD chunk scan.

Replaces the TPU kernel ``_ssd_kernel`` (``repro/kernels/ssd_chunk.py``).
The TPU grid ran the chunks in order and carried the ``[P, N]`` state in
VMEM; blocks on Hopper run in no order, so the CUDA kernel
(``csrc/ssd_chunk.cu``) gives one block a whole (batch·head) sequence,
loops over its chunks and keeps the f32 state in shared memory.  At
mamba2-2.7b's shape its operation and byte bounds are of one size.

``b`` and ``c`` may be shared by ``heads_per_bc`` consecutive sequences
(Mamba-2's single B/C group): sequence ``i`` reads row
``i // heads_per_bc``, with no per-head copy.  With ``return_state`` the
kernel also writes the f32 state after the last step, which the prefill
hands to the decode cache.  CPU tensors take the plain
version (``ref.py``); CUDA tensors launch the kernel or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

launches = _build.LaunchCount()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N, _MAX_CHUNK = 64, 128, 256  # the kernel's shared-memory tiles


def ssd_scan(
    x: torch.Tensor,  # [BH, S, P]
    a: torch.Tensor,  # [BH, S] per-step decay in (0, 1]
    b: torch.Tensor,  # [BH // heads_per_bc, S, N]
    c: torch.Tensor,  # [BH // heads_per_bc, S, N]
    chunk: int = 256,
    *,
    heads_per_bc: int = 1,
    return_state: bool = False,
):
    """Full-sequence SSD scan ``y[t] = Σ_{s≤t} Π a · x_s b_sᵀ c_t`` in f32,
    returned in ``x.dtype``; ``S`` must be a multiple of ``chunk``.  With
    ``return_state``, returns ``(y, state)``, the state ``[BH, P, N]`` f32
    after the last step."""
    if x.dim() != 3 or a.dim() != 2 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError("ssd_scan wants x [BH,S,P], a [BH,S], b and c [BH/h,S,N]")
    bh, s, p = x.shape
    n = b.shape[-1]
    if heads_per_bc < 1 or bh % heads_per_bc or b.shape[0] != bh // heads_per_bc:
        raise ValueError(f"b/c rows {b.shape[0]} do not serve {bh} sequences "
                         f"at {heads_per_bc} per row")
    if a.shape != (bh, s) or b.shape[1] != s:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share float32 or bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    tensors = (x, a, b, c)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_ref(x, a, b, c, chunk, heads_per_bc, return_state)
    device = x.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("ssd_scan: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: tensors must be contiguous")
    if p > _MAX_P or n > _MAX_N or chunk > _MAX_CHUNK:
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} above the kernel's "
                         f"{_MAX_P}, {_MAX_N}, {_MAX_CHUNK}")
    if bh > 2**31 - 1:
        raise ValueError(f"ssd_scan: {bh} sequences is too many")
    y = torch.empty_like(x)
    state = torch.zeros((bh, p, n), dtype=torch.float32, device=device) if return_state else None
    if x.numel() == 0:
        return (y, state) if return_state else y
    a32 = a.to(torch.float32).contiguous()
    lib = _build.load("ssd_chunk")
    rc = lib.atlas_ssd_chunk(
        _build.ptr(x), _build.ptr(a32), _build.ptr(b), _build.ptr(c), _build.ptr(y),
        None if state is None else _build.ptr(state),
        bh, s, p, n, chunk, heads_per_bc, _DTYPES[x.dtype], _build.stream_handle(device),
    )
    _build.check(rc, lib, "ssd_chunk")
    launches.add()
    return (y, state) if return_state else y
