"""K3: causal GQA flash attention, forward.

Replaces the TPU kernel ``_flash_kernel`` (``repro/kernels/flash_attention.py``).
Both routes in ``csrc/flash_attention.cu`` run one block per (batch·q-head,
64-row q tile), walk the 64-row KV tiles inside the block up to the causal
diagonal with the online-softmax state in registers, and read KV head
``q_head // group`` without repeating KV.  ``route`` picks one from the
dtype, the head dim and the alignment, never by trying one and catching:

- ``"tensor_core"``: bf16 with head dim 64 or 128 on 16-byte aligned
  tensors: wgmma for QKᵀ and PV, K/V tiles by TMA through a two-stage
  mbarrier ring, P rounded to bf16 in registers for the PV product.
- ``"cuda_core"``: f32 (ahead of SDPA's f32 path) and bf16 at other head
  dims: f32 FMAs with P kept in f32.

It is bound by operations at long prompts and by bytes at short ones.
Unlike the TPU kernel it takes any sequence length: the ragged last tile
is masked.  CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the route's kernel or raise.  ``launches`` counts every launch,
``tensor_core_launches`` and ``cuda_core_launches`` (``route_launches[route]``)
each route's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

launches = _build.LaunchCount()
tensor_core_launches = _build.LaunchCount()
cuda_core_launches = _build.LaunchCount()
route_launches = {"tensor_core": tensor_core_launches, "cuda_core": cuda_core_launches}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_GRID_Y = 65535  # the kernel's grid puts batch·q-heads on y
_TC_HEAD_DIMS = (64, 128)  # the published head dims of every ported model


def route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: ``"tensor_core"`` for bf16 with head
    dim 64 or 128 on 16-byte aligned q, k, v, else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS and aligned:
        return "tensor_core"
    return "cuda_core"


def flash_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    causal: bool = True,
) -> torch.Tensor:
    """Softmax attention with f32 scores and accumulator (probabilities in
    f32 on the CUDA-core route, bf16 on the tensor-core route); returns
    ``[B, Hq, S, D]`` in ``q.dtype``."""
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
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_ref(q, k, v, causal)
    device = q.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("flash_attention: all tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: tensors must be contiguous")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} above {_MAX_HEAD_DIM}")
    if b * hq > _MAX_GRID_Y or s > 2**31 - 1:
        raise ValueError(f"flash_attention: B·Hq={b * hq} or S={s} too large")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b * hq, s, d, hq // hkv, 1.0 / d**0.5, int(causal))
    stream = _build.stream_handle(device)
    path = route(q.dtype, d, aligned=all(t.data_ptr() % 16 == 0 for t in tensors))
    if path == "tensor_core":
        rc = lib.atlas_flash_attention_tc(*args, stream)
    else:
        rc = lib.atlas_flash_attention(*args, _DTYPES[q.dtype], stream)
    _build.check(rc, lib, "flash_attention")
    launches.add()
    route_launches[path].add()
    return out
