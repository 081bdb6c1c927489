"""Shared neural layers of the LM stack, ported from ``repro/models/layers.py``.

Plain functions on tensors; parameters are dicts of tensors built by the
``init_*`` helpers from an explicit ``torch.Generator`` on an explicit
device.  ``rms_norm`` runs K5 and ``blockwise_attention`` runs K3 on CUDA
tensors (their plain versions on CPU tensors); ``decode_attention``,
the MLPs and ``cross_entropy`` stay plain PyTorch, as the JAX package left
them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """``N(0, 1/d_in)`` weights, drawn in f32 and cast to ``dtype``."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / d_in) ** 0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    e = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=device)
    return (e * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·(1+scale)`` over the last axis in f32, cast
    back to ``x.dtype`` (K5)."""
    return ops.rms_norm(x, scale, eps)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """``(cos, sin)`` of the rotary angles at ``positions`` ([S] or [B, S]),
    shaped to broadcast over ``[B, H, S, D/2]``."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # [D/2]
    if positions.dim() == 1:
        ang = positions.to(torch.float32)[:, None] * freqs[None, :]  # [S, D/2]
        ang = ang[None, None]  # [1, 1, S, D/2]
    else:
        ang = positions.to(torch.float32)[..., None] * freqs  # [B, S, D/2]
        ang = ang[:, None]  # [B, 1, S, D/2]
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` [B, H, S, D] rotated by ``rope_angles``' cos and sin, in f32."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, H, S, D], positions: [S] or [B, S]; split-halves form in f32."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def blockwise_attention(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    *,
    causal: bool = True,
    window: int | None = None,  # sliding-window (local) attention
) -> torch.Tensor:
    """Online-softmax GQA attention (K3): f32 scores, probabilities and
    accumulator, any sequence length; with ``window``, query q sees key k
    only if ``q - k < window`` (the hybrid family's local attention)."""
    return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal, window)


def decode_attention(
    q: torch.Tensor,  # [B, Hq, 1, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    length: int,  # current context length (positions < length valid)
) -> torch.Tensor:
    """One-token attention against a partly filled KV cache, plain
    PyTorch: scores and softmax in f32, probabilities cast to the cache's
    dtype before the f32 PV product, as the JAX package does."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    group = hq // hkv
    s = k_cache.shape[2]
    qg = q.reshape(b, hkv, group, d).float()
    scores = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) * (1.0 / d**0.5)
    valid = torch.arange(s, device=q.device) < length
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgk,bhkd->bhgd", probs.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.reshape(b, hq, 1, d).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype, device) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "gate": dense_init(gen, d_model, d_ff, dtype, device),
            "up": dense_init(gen, d_model, d_ff, dtype, device),
            "down": dense_init(gen, d_ff, d_model, dtype, device),
        }
    if kind == "gelu":
        return {
            "up": dense_init(gen, d_model, d_ff, dtype, device),
            "up_b": torch.zeros((d_ff,), dtype=dtype, device=device),
            "down": dense_init(gen, d_ff, d_model, dtype, device),
            "down_b": torch.zeros((d_model,), dtype=dtype, device=device),
        }
    raise ValueError(kind)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_hidden(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP's activation, before its ``down`` projection."""
    if kind == "swiglu":
        return F.silu(x @ params["gate"]) * (x @ params["up"])
    if kind == "gelu":
        return _gelu(x @ params["up"] + params["up_b"])
    if kind == "geglu":
        return _gelu(x @ params["gate"]) * (x @ params["up"])
    raise ValueError(kind)


def mlp_forward(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    y = mlp_hidden(params, x, kind) @ params["down"]
    return y + params["down_b"] if kind == "gelu" else y


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits [B,S,V] upcast to f32, labels [B,S] int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
