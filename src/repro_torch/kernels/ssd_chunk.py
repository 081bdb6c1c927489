"""K4: the Mamba-2 SSD chunk scan.

Replaces the TPU kernel ``_ssd_kernel`` (``repro/kernels/ssd_chunk.py``).
The TPU grid ran the chunks in order and carried the ``[P, N]`` state in
VMEM; blocks on Hopper run in no order.  Two routes in
``csrc/ssd_chunk.cu``, picked by ``route`` from the dtype, the shape and
the alignment, never by trying one and catching:

- ``"tensor_core"``: bf16 with ``P == 64``, ``N`` 64 or 128 and a chunk
  that is a multiple of 64 (at most 256), on 16-byte aligned x, b, c:
  Mamba-2's chunked decomposition in three launches (chunk-local states
  on ``wgmma``, an f32 state pass in chunk order, then every (sequence,
  chunk, 64-row tile) of outputs on ``wgmma`` with TMA-fed tiles).  The
  f32 operands of the tensor cores (the weighted x, the carried state and
  the decayed ``C Bᵀ``) enter as bf16 hi + lo pairs, so only the output is
  rounded to bf16.  The wrapper allocates the scratch.
- ``"cuda_core"``: f32 and every other shape: one block per (batch·head)
  sequence loops over its chunks with the f32 state in shared memory.

At mamba2-2.7b's shape the operation and byte bounds are of one size.
``b`` and ``c`` may be shared by ``heads_per_bc`` consecutive sequences
(Mamba-2's single B/C group): sequence ``i`` reads row
``i // heads_per_bc``, with no per-head copy.  With ``return_state`` the
kernel also writes the f32 state after the last step, which the prefill
hands to the decode cache.  CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the route's kernel or raise.
``launches`` counts ``ssd_scan`` calls that launched (one per call, however
many CUDA launches the route makes), ``tensor_core_launches`` and
``cuda_core_launches`` (``route_launches[route]``) each route's.

``ssd_scan_bwd`` is the gradient (no Pallas counterpart: the reference
differentiates its jnp twin ``ssd_chunked`` with XLA), with the forward's
two routes under the forward's rule (``bwd_route``):

- ``"tensor_core"``: seven launches.  Every chunk's input state ``S_in``
  and the state gradient ``dS`` reaching it, from the forward's
  chunk-local passes on ``wgmma`` and their mirror (``(e^cl∘dY)ᵀ C``),
  each carried by an f32 pass and written as bf16 hi + lo; then one block
  per (b/c row, chunk, group of up to 8 heads that share the row, 64-row
  tile): the five T×T products and the three state products on
  ``wgmma``, f32 operands as hi + lo, dB and dC summed over the group's
  heads in registers; then the groups' f32 partials added in order, and
  ``da`` by a warpgroup scan per (sequence, chunk).
- ``"cuda_core"``: f32 and every other shape: three launches in f32 (the
  input states and state gradients, one sequence per block, forwards and
  backwards; one block per (sequence, chunk) for dx, da and each head's
  db and dc as f32 partials; the heads' partials added in head order).

Neither uses float atomics.  ``bwd_launches`` counts every call,
``bwd_tensor_core_launches`` and ``bwd_cuda_core_launches``
(``bwd_route_launches[route]``) each route's.  ``ssd_scan_grad`` is the
differentiable op (``torch.autograd.Function``) whose forward is
``ssd_scan`` and whose backward is ``ssd_scan_bwd``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref

launches = _build.LaunchCount()
bwd_launches = _build.LaunchCount()
tensor_core_launches = _build.LaunchCount()
cuda_core_launches = _build.LaunchCount()
route_launches = {"tensor_core": tensor_core_launches, "cuda_core": cuda_core_launches}
bwd_tensor_core_launches = _build.LaunchCount()
bwd_cuda_core_launches = _build.LaunchCount()
bwd_route_launches = {"tensor_core": bwd_tensor_core_launches,
                      "cuda_core": bwd_cuda_core_launches}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_P, _MAX_N, _MAX_CHUNK = 64, 128, 256  # the kernels' shared-memory tiles
_TC_P, _TC_N, _TC_TILE = 64, (64, 128), 64  # the tensor-core route's tiles
_BWD_MAX_HEADS = 8  # heads whose db and dc one tensor-core backward block sums


def route(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"tensor_core"`` for bf16 with
    ``p == 64``, ``n`` 64 or 128, ``chunk % 64 == 0`` (up to 256) and
    16-byte aligned x, b, c, else ``"cuda_core"``."""
    if (dtype == torch.bfloat16 and p == _TC_P and n in _TC_N and chunk % _TC_TILE == 0
            and 0 < chunk <= _MAX_CHUNK and aligned):
        return "tensor_core"
    return "cuda_core"


def bwd_route(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool = True) -> str:
    """The backward kernel a CUDA call of ``ssd_scan_bwd`` takes: the
    forward's rule (``route``), aligned when x, b, c and dy start on 16
    bytes."""
    return route(dtype, p, n, chunk, aligned)


def bwd_head_group(heads_per_bc: int) -> int:
    """Heads whose db and dc one tensor-core backward block sums in head
    order: the largest divisor of ``heads_per_bc`` up to 8."""
    return max(g for g in range(1, _BWD_MAX_HEADS + 1) if heads_per_bc % g == 0)


def _check_args(x, a, b, c, chunk: int, heads_per_bc: int) -> None:
    if x.dim() != 3 or a.dim() != 2 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError("ssd_scan wants x [BH,S,P], a [BH,S], b and c [BH/h,S,N]")
    bh, s, _ = x.shape
    if heads_per_bc < 1 or bh % heads_per_bc or b.shape[0] != bh // heads_per_bc:
        raise ValueError(f"b/c rows {b.shape[0]} do not serve {bh} sequences "
                         f"at {heads_per_bc} per row")
    if a.shape != (bh, s) or b.shape[1] != s:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c must share float32 or bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")


def _check_card(name: str, tensors, p: int, n: int, chunk: int) -> torch.device:
    """The one CUDA device of ``tensors``, which the kernels take as they are."""
    device = tensors[0].device
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if p > _MAX_P or n > _MAX_N or chunk > _MAX_CHUNK:
        raise ValueError(f"{name}: P={p}, N={n}, chunk={chunk} above the kernel's "
                         f"{_MAX_P}, {_MAX_N}, {_MAX_CHUNK}")
    bh, s = tensors[0].shape[:2]
    if bh * s // _TC_TILE > 2**31 - 1:
        raise ValueError(f"{name}: {bh} sequences of {s} steps is too many")
    return device


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
    _check_args(x, a, b, c, chunk, heads_per_bc)
    bh, s, p = x.shape
    n = b.shape[-1]
    tensors = (x, a, b, c)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_ref(x, a, b, c, chunk, heads_per_bc, return_state)
    device = _check_card("ssd_scan", tensors, p, n, chunk)
    y = torch.empty_like(x)
    state = torch.zeros((bh, p, n), dtype=torch.float32, device=device) if return_state else None
    if x.numel() == 0:
        return (y, state) if return_state else y
    a32 = a.to(torch.float32).contiguous()
    path = route(x.dtype, p, n, chunk, aligned=all(t.data_ptr() % 16 == 0 for t in (x, b, c)))
    if path == "tensor_core":
        nc = s // chunk
        cl = torch.empty((bh, s), dtype=torch.float32, device=device)
        states = torch.empty((bh, nc, p, n), dtype=torch.float32, device=device)
        hi = torch.empty((bh, nc, p, n), dtype=torch.bfloat16, device=device)
        lo = torch.empty_like(hi)
    _build.note("ssd_scan", (x, a32, b, c), (y,) if state is None else (y, state), chunk=chunk,
                heads_per_bc=heads_per_bc)
    if _build.planned(device):
        return (y, state) if return_state else y
    lib = _build.load("ssd_chunk")
    stream = _build.stream_handle(device)
    st_ptr = None if state is None else _build.ptr(state)
    if path == "tensor_core":
        rc = lib.atlas_ssd_chunk_tc(
            _build.ptr(x), _build.ptr(a32), _build.ptr(b), _build.ptr(c), _build.ptr(y), st_ptr,
            _build.ptr(cl), _build.ptr(states), _build.ptr(hi), _build.ptr(lo),
            bh, s, n, chunk, heads_per_bc, stream,
        )
    else:
        rc = lib.atlas_ssd_chunk(
            _build.ptr(x), _build.ptr(a32), _build.ptr(b), _build.ptr(c), _build.ptr(y), st_ptr,
            bh, s, p, n, chunk, heads_per_bc, _DTYPES[x.dtype], stream,
        )
    _build.check(rc, lib, "ssd_chunk")
    launches.add()
    route_launches[path].add()
    return (y, state) if return_state else y


def ssd_scan_bwd(
    x: torch.Tensor,  # [BH, S, P]
    a: torch.Tensor,  # [BH, S]
    b: torch.Tensor,  # [BH // heads_per_bc, S, N]
    c: torch.Tensor,  # [BH // heads_per_bc, S, N]
    dy: torch.Tensor,  # [BH, S, P]
    chunk: int = 256,
    *,
    heads_per_bc: int = 1,
):
    """``(dx, da, db, dc)`` of ``ssd_scan(x, a, b, c, chunk)`` for the
    output gradient ``dy``; f32 math, each gradient in its input's dtype.
    On the card (route by ``bwd_route``): the chunks' input states and
    state gradients, then the chunks' products, then the f32 partials of
    db and dc added in order: no float atomics.  CPU tensors take
    ``ssd_scan_bwd_ref``."""
    _check_args(x, a, b, c, chunk, heads_per_bc)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} is not x's "
                         f"{tuple(x.shape)} {x.dtype}")
    bh, s, p = x.shape
    n = b.shape[-1]
    tensors = (x, a, b, c, dy)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_bwd_ref(x, a, b, c, dy, chunk, heads_per_bc)
    device = _check_card("ssd_scan_bwd", tensors, p, n, chunk)
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    if x.numel() == 0:
        return dx, torch.zeros_like(a), db.zero_(), dc.zero_()
    a32 = a.to(torch.float32).contiguous()
    da = torch.empty((bh, s), dtype=torch.float32, device=device)
    nc = s // chunk
    path = bwd_route(x.dtype, p, n, chunk, aligned=all(t.data_ptr() % 16 == 0 for t in (x, b, c, dy)))
    if path == "tensor_core":
        group = bwd_head_group(heads_per_bc)
        cl = torch.empty((bh, s), dtype=torch.float32, device=device)
        states = torch.empty((bh, nc, p, n), dtype=torch.float32, device=device)
        pairs = torch.empty((4, bh, nc, p, n), dtype=torch.bfloat16, device=device)  # S_in, dS
        dcl = torch.empty((3, bh, s), dtype=torch.float32, device=device)
        dss = torch.empty((bh, nc), dtype=torch.float32, device=device)
        partials = torch.empty((2, bh // heads_per_bc, heads_per_bc // group, s, n),
                               dtype=torch.float32, device=device)
    else:
        states = torch.empty((2, bh, nc, p, n), dtype=torch.float32, device=device)
        partials = torch.empty((2, bh, s, n), dtype=torch.float32, device=device)
    _build.note("ssd_scan_bwd", (x, a32, b, c, dy), (dx, da, db, dc), chunk=chunk,
                heads_per_bc=heads_per_bc)
    if _build.planned(device):
        return dx, da.to(a.dtype), db, dc
    lib = _build.load("ssd_chunk")
    stream = _build.stream_handle(device)
    if path == "tensor_core":
        rc = lib.atlas_ssd_chunk_bwd_tc(
            *(_build.ptr(t) for t in (x, a32, b, c, dy, dx, da, db, dc, cl, states, *pairs, dcl,
                                      dss, partials[0], partials[1])),
            bh, s, n, chunk, heads_per_bc, group, stream,
        )
    else:
        rc = lib.atlas_ssd_chunk_bwd(
            *(_build.ptr(t) for t in (x, a32, b, c, dy, dx, da, db, dc, states[0], states[1],
                                      partials[0], partials[1])),
            bh, s, p, n, chunk, heads_per_bc, _DTYPES[x.dtype], stream,
        )
    _build.check(rc, lib, "ssd_chunk")
    bwd_launches.add()
    bwd_route_launches[path].add()
    return dx, da.to(a.dtype), db, dc


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, c, chunk, heads_per_bc):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk, ctx.heads_per_bc = chunk, heads_per_bc
        return ssd_scan(x, a, b, c, chunk, heads_per_bc=heads_per_bc)

    @staticmethod
    def backward(ctx, dy):
        x, a, b, c = ctx.saved_tensors
        grads = ssd_scan_bwd(x, a, b, c, dy.contiguous(), ctx.chunk,
                             heads_per_bc=ctx.heads_per_bc)
        return (*grads, None, None)


def ssd_scan_grad(x, a, b, c, chunk: int = 256, *, heads_per_bc: int = 1,
                  return_state: bool = False) -> torch.Tensor:
    """``ssd_scan`` that autograd differentiates through ``ssd_scan_bwd``.
    ``return_state`` raises ``ValueError``: training never asks for the
    final state, and its gradient is not computed."""
    if return_state:
        raise ValueError("ssd_scan_grad: return_state=True has no gradient; call ssd_scan "
                         "without autograd for the final state")
    return _SsdScan.apply(x, a, b, c, chunk, heads_per_bc)
