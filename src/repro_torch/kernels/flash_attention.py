"""K3: causal GQA flash attention, forward, with an optional sliding window.

Replaces the TPU kernel ``_flash_kernel`` (``repro/kernels/flash_attention.py``).
Both routes in ``csrc/flash_attention.cu`` run one block per (batch·q-head,
64-row q tile), walk the 64-row KV tiles inside the block up to the causal
diagonal with the online-softmax state in registers, and read KV head
``q_head // group`` without repeating KV.  ``route`` picks one from the
dtype, the head dim and the alignment, never by trying one and catching:

- ``"tensor_core"``: bf16 with head dim 64, 128 or 256 on 16-byte aligned
  tensors, with or without a window: wgmma for QKᵀ and PV, K/V tiles by
  TMA through a two-stage mbarrier ring, P rounded to bf16 in registers
  for the PV product.
- ``"cuda_core"``: f32 (ahead of SDPA's f32 path), bf16 at other head
  dims (up to 256) and on views off 16 bytes: f32 FMAs with P kept in f32.

With a window (the hybrid family's local attention; the Pallas kernel has
none, the reference's jnp ``blockwise_attention(window=)`` does), query q
sees key k iff ``q - k < window`` (and ``k <= q`` when causal): on both
routes the KV walk starts at the tile that holds the band's first key,
and the band's edge tiles are masked.  A window of S or more gives the
no-window result bit for bit.

It is bound by operations at long prompts and by bytes at short ones.
Unlike the TPU kernel it takes any sequence length: the ragged last tile
is masked.  CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the route's kernel or raise.  ``launches`` counts every launch,
``tensor_core_launches`` and ``cuda_core_launches`` (``route_launches[route]``)
each route's.

``flash_attention_bwd`` is the gradient (no Pallas counterpart: the
reference differentiates its jnp attention with XLA), a dQ kernel and then
a dK/dV kernel in the FlashAttention-2 form, with no float atomics.  It
takes the forward's two routes under the same rule (``bwd_route``), and
both skip the tiles outside the band:

- ``"tensor_core"`` (bf16, head dim 64, 128 or 256, 16-byte aligned): the
  64×64×D products of a pair of tiles on wgmma with TMA-fed tiles; P and
  dS rounded to bf16 in registers as wgmma's A operand.  At head dim 64
  and 128 the dK/dV block keeps K and V resident and walks its group's q
  heads in order.  At 256 (recurrentgemma) dK and dV take a warpgroup
  each (Pᵀ handed from one to the other through shared memory), one
  block per (kv tile, q head) writes f32 partials, and a third kernel sums
  them over the group in a fixed order.
- ``"cuda_core"`` (f32, other head dims up to 256, unaligned views): f32
  FMAs.  Its dK/dV kernel runs one block per (kv tile, q head, run of up
  to 8 q tiles) into f32 partials, which a third kernel sums in a fixed
  order: each f32 chain holds at most 512 rows, also for a group of 16
  heads over a band of 2048 queries.

``bwd_launches`` counts every call, ``bwd_tensor_core_launches`` and
``bwd_cuda_core_launches`` (``bwd_route_launches[route]``) each route's.
``flash_attention_grad`` is the differentiable op
(``torch.autograd.Function``): its forward runs the route's kernel and
also writes each row's log-sum-exp, which the backward uses to recompute
the probabilities.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)

launches = _build.LaunchCount()
bwd_launches = _build.LaunchCount()
tensor_core_launches = _build.LaunchCount()
cuda_core_launches = _build.LaunchCount()
route_launches = {"tensor_core": tensor_core_launches, "cuda_core": cuda_core_launches}
bwd_tensor_core_launches = _build.LaunchCount()
bwd_cuda_core_launches = _build.LaunchCount()
bwd_route_launches = {"tensor_core": bwd_tensor_core_launches, "cuda_core": bwd_cuda_core_launches}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65535  # the kernel's grid puts batch·q-heads on y
_TC_HEAD_DIMS = (64, 128, 256)  # the published head dims of every ported model


def route(dtype: torch.dtype, d: int, aligned: bool = True, window: int | None = None) -> str:
    """The kernel a CUDA call takes: ``"tensor_core"`` for bf16 with head
    dim 64, 128 or 256 on 16-byte aligned q, k, v, with or without a
    window, else ``"cuda_core"``.  ``window`` does not change the route:
    both kernels take the band."""
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS and aligned:
        return "tensor_core"
    return "cuda_core"


def bwd_route(q, k, v, out, dout, window: int | None = None) -> str:
    """The backward kernel a CUDA call of ``flash_attention_bwd`` takes:
    the forward's rule (``route``) on q's dtype and head dim and the
    window, aligned when all five inputs start on 16 bytes."""
    tensors = (q, k, v, out, dout)
    return route(q.dtype, q.shape[-1], all(t.data_ptr() % 16 == 0 for t in tensors), window)


def _window_arg(window: int | None) -> int:
    """The C entry points' window: 0 for none."""
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"flash_attention: window {window} must be at least 1")
    return int(window)


def flash_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    causal: bool = True,
    lse: torch.Tensor | None = None,  # [B·Hq, S] f32
    window: int | None = None,
) -> torch.Tensor:
    """Softmax attention with f32 scores and accumulator (probabilities in
    f32 on the CUDA-core route, bf16 on the tensor-core route), over the
    keys ``k <= q`` (causal) with ``q - k < window`` (a window); returns
    ``[B, Hq, S, D]`` in ``q.dtype``.  Given ``lse``, the kernel also
    writes each row's log-sum-exp of the scaled scores into it (for the
    backward); without it, it writes nothing more."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention wants q [B,Hq,S,D] and k, v [B,Hkv,S,D]")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v)
    win = _window_arg(window)
    if all(t.device.type == "cpu" for t in tensors):
        if lse is not None:
            lse.copy_(flash_attention_lse_ref(q, k, causal, window))
        return flash_attention_ref(q, k, v, causal, window)
    device = q.device
    if device.type not in _build.CARD_TYPES or any(t.device != device for t in tensors):
        raise ValueError("flash_attention: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: tensors must be contiguous")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} above {_MAX_HEAD_DIM}")
    if b * hq > _MAX_GRID_Y or s > 2**31 - 1:
        raise ValueError(f"flash_attention: B·Hq={b * hq} or S={s} too large")
    if lse is not None and (lse.shape != (b * hq, s) or lse.dtype != torch.float32
                            or lse.device != device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous [{b * hq}, {s}] float32 "
                         f"tensor on {device}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    _build.note("flash_attention", tensors, (out,), causal=causal, window=window)
    if _build.planned(device):
        return out
    lib = _build.load("flash_attention")
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            None if lse is None else _build.ptr(lse),
            b * hq, s, d, hq // hkv, 1.0 / d**0.5, int(causal))
    stream = _build.stream_handle(device)
    path = route(q.dtype, d, all(t.data_ptr() % 16 == 0 for t in tensors), window)
    if path == "tensor_core":
        rc = lib.atlas_flash_attention_tc(*args, win, stream)
    else:
        rc = lib.atlas_flash_attention(*args, win, _DTYPES[q.dtype], stream)
    _build.check(rc, lib, "flash_attention")
    launches.add()
    route_launches[path].add()
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: int | None = None):
    """``(dq, dk, dv)`` of ``flash_attention(q, k, v, causal, window=window)`` for the
    output gradient ``dout``, given the forward's ``out`` and ``lse``
    (``[B·Hq, S]`` f32); f32 accumulation, results in the inputs' dtype.
    On the card (route by ``bwd_route``): a dQ kernel (which also writes
    ``delta = rowsum(dO∘O)``), then the dK/dV pass, which sums each KV
    head's group in a fixed order (inside one block, or over f32 partials
    by a third kernel): no float atomics.  CPU tensors take
    ``flash_attention_bwd_ref`` (``lse`` unused)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (out.shape != q.shape or dout.shape != q.shape or k.shape != v.shape
            or k.shape != (b, hkv, s, d) or hkv == 0 or hq % hkv):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, out {tuple(out.shape)}, dout {tuple(dout.shape)}")
    tensors = (q, k, v, out, dout)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("flash_attention_bwd: q, k, v, out and dout must share float32 or bfloat16")
    win = _window_arg(window)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_bwd_ref(q, k, v, out, dout, causal, window)
    device = q.device
    if (device.type not in _build.CARD_TYPES
            or any(t.device != device for t in (*tensors, lse))):
        raise ValueError("flash_attention_bwd: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in (*tensors, lse)):
        raise ValueError("flash_attention_bwd: tensors must be contiguous")
    if lse.shape != (b * hq, s) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be [{b * hq}, {s}] float32")
    if d > _MAX_HEAD_DIM or b * hq > _MAX_GRID_Y or s > 2**31 - 1:
        raise ValueError(f"flash_attention_bwd: D={d}, B·Hq={b * hq} or S={s} too large")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dims = (b * hq, s, d, hq // hkv, 1.0 / d**0.5, int(causal))
    path = bwd_route(q, k, v, out, dout, window)
    if path == "tensor_core":
        # lse in log2 units and delta, each padded to whole 64-row tiles; at
        # head dim 256 also each q head's dK and dV before the group's sum
        scratch = torch.empty((2, b * hq, -(-s // 64) * 64), dtype=torch.float32, device=device)
        partials = (torch.empty((2, b * hq, s, d), dtype=torch.float32, device=device)
                    if d == 256 else None)
        _build.note("flash_attention_bwd", (*tensors, lse), (dq, dk, dv), causal=causal,
                    window=window)
        if _build.planned(device):
            return dq, dk, dv
        lib = _build.load("flash_attention")
        stream = _build.stream_handle(device)
        rc = lib.atlas_flash_attention_bwd_tc(
            *(_build.ptr(t) for t in (q, k, v, out, dout, lse, scratch)),
            None if partials is None else _build.ptr(partials),
            *(_build.ptr(t) for t in (dq, dk, dv)), *dims, win, stream,
        )
    else:
        rc = _bwd_cuda_core(q, k, v, out, lse, dout, dq, dk, dv, dims, win)
        if rc is None:
            return dq, dk, dv
    _build.check(rc, _build.load("flash_attention"), "flash_attention")
    bwd_launches.add()
    bwd_route_launches[path].add()
    return dq, dk, dv


def _bwd_runs(s: int, win: int, causal: int) -> int:
    """``bwd::max_q_runs`` of ``csrc/flash_attention.cu``: the most runs of
    8 q tiles (64 rows each) that any kv tile's dK/dV blocks walk, the
    partials' slots per head.  The ``meta`` route sizes its scratch by it."""
    n_q = -(-s // 64)
    most = 0
    for kt in range(n_q):
        end = n_q if win <= 0 else min((kt * 64 + 63 + win - 1) // 64 + 1, n_q)
        most = max(most, -(-(end - (kt if causal else 0)) // 8))
    return most


def _bwd_cuda_core(q, k, v, out, lse, dout, dq, dk, dv, dims, win: int) -> int | None:
    """The CUDA-core backward's three launches (dQ; the dK/dV partials, one
    block per kv tile, q head and run of q tiles; their fixed-order sum)
    into ``dq``, ``dk``, ``dv``; returns the C entry's code (None on
    ``meta``: its scratch allocated, nothing launched).  Counts nothing:
    ``flash_attention_bwd`` does."""
    bhq, s, d, group, _, causal = dims
    planned = _build.planned(q.device)
    lib = None if planned else _build.load("flash_attention")
    runs = _bwd_runs(s, win, causal) if planned else lib.atlas_flash_attention_bwd_runs(
        s, win, causal)
    delta = torch.empty((bhq, s), dtype=torch.float32, device=q.device)
    partials = torch.empty((2, group * runs, bhq // group, s, d), dtype=torch.float32,
                           device=q.device)
    _build.note("flash_attention_bwd", (q, k, v, out, dout, lse), (dq, dk, dv),
                causal=bool(causal), window=win or None)
    if planned:
        return None
    return lib.atlas_flash_attention_bwd(
        *(_build.ptr(t) for t in (q, k, v, out, dout, lse, delta, partials, dq, dk, dv)),
        *dims, win, runs, _DTYPES[q.dtype], _build.stream_handle(q.device),
    )


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        b, hq, s, _ = q.shape
        lse = torch.empty((b * hq, s), dtype=torch.float32, device=q.device)
        out = flash_attention(q, k, v, causal, lse=lse, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention_grad(q, k, v, causal: bool = True, window: int | None = None) -> torch.Tensor:
    """``flash_attention`` on CUDA tensors that autograd differentiates
    through ``flash_attention_bwd``."""
    return _FlashAttention.apply(q, k, v, causal, window)
