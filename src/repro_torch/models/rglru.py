"""RG-LRU recurrent block (recurrentgemma-9b / Griffin), ported from
``repro/models/rglru.py``.

Griffin recurrent block: two linear branches; branch 1 goes through a
short causal conv then the Real-Gated LRU; branch 2 gates it with GeLU.

  r_t = sigmoid(W_r u_t + b_r)              (recurrence gate)
  i_t = sigmoid(W_i u_t + b_i)              (input gate)
  a_t = exp(-c * softplus(Lambda) * r_t)    (per-channel decay, c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full-sequence path (prefill and training) runs the recurrence as K6
(``ops.rglru_scan``: a chunked scan kernel on the card, whose backward is
its reverse recurrence); the JAX package runs it with
``jax.lax.associative_scan``.  The decode path is one elementwise step in
plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.models.mamba import causal_conv1d

_C = 8.0


def gate_blocks(d_rnn: int, n_gate_blocks: int = 16) -> int:
    """The gates' diagonal blocks: ``n_gate_blocks``, halved until they
    divide ``d_rnn``."""
    nb = min(n_gate_blocks, d_rnn)
    while d_rnn % nb:
        nb //= 2
    return nb


def init_rglru_block(
    gen: torch.Generator, d_model: int, d_rnn: int, conv_width: int, dtype, device,
    n_gate_blocks: int = 16,
) -> dict:
    """Gate matrices are block-diagonal (Griffin §2.4): ``n_gate_blocks``
    blocks of ``d_rnn / n_gate_blocks`` channels, halved until they divide
    ``d_rnn``."""
    nb = gate_blocks(d_rnn, n_gate_blocks)
    blk = d_rnn // nb
    scale = (1.0 / blk) ** 0.5
    f32 = dict(dtype=torch.float32, device=device)
    in1 = dense_init(gen, d_model, d_rnn, dtype, device)
    in2 = dense_init(gen, d_model, d_rnn, dtype, device)
    conv = (torch.randn((conv_width, d_rnn), generator=gen, **f32) * 0.1).to(dtype)
    w_r = (torch.randn((nb, blk, blk), generator=gen, **f32) * scale).to(dtype)
    w_i = (torch.randn((nb, blk, blk), generator=gen, **f32) * scale).to(dtype)
    return {
        "in1": in1,
        "in2": in2,
        "conv": conv,
        "w_r": w_r,
        "w_i": w_i,
        "lam": torch.full((d_rnn,), 0.5, **f32),
        "wo": dense_init(gen, d_rnn, d_model, dtype, device),
    }


def _block_diag_matmul(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u [..., R] x block-diagonal w [nb, blk, blk] -> [..., R]."""
    nb, blk, _ = w.shape
    ub = u.reshape(u.shape[:-1] + (nb, blk))
    out = torch.einsum("...nb,nbc->...nc", ub, w)
    return out.reshape(u.shape)


def _gates(params: dict, u: torch.Tensor):
    """The decay ``a`` and input ``w`` of the recurrence, both f32."""
    r = torch.sigmoid(_block_diag_matmul(u, params["w_r"]).to(torch.float32))
    i = torch.sigmoid(_block_diag_matmul(u, params["w_i"]).to(torch.float32))
    a = torch.exp(-_C * F.softplus(params["lam"]) * r)
    w = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.to(torch.float32))
    return a, w


def rglru_scan(a: torch.Tensor, w: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + w_t over axis 1 ([B, S, R] f32), K6."""
    return ops.rglru_scan(a.contiguous(), w.contiguous(), h0)


def rglru_inner(params: dict, x: torch.Tensor, *, return_cache: bool = False):
    """The mixer on ``x [B, S, D]`` up to its out-projection: ``(y [B, S,
    R], cache)``, ``cache`` as ``rglru_forward``'s (None without
    ``return_cache``).  The channels are those of ``params``' columns and
    gate blocks: the sharded step gives each model position its own
    (``distributed/spmd.py``)."""
    u1 = x @ params["in1"]
    u2 = F.gelu(x @ params["in2"], approximate="tanh")
    a, w = _gates(params, causal_conv1d(u1, params["conv"]))
    h = rglru_scan(a, w)
    y = h.to(x.dtype) * u2
    if not return_cache:
        return y, None
    keep = params["conv"].shape[0] - 1
    padded = F.pad(u1, (0, 0, max(keep - u1.shape[1], 0), 0))
    return y, {"conv": padded[:, padded.shape[1] - keep:], "h": h[:, -1]}


def rglru_forward(params: dict, x: torch.Tensor, *, return_cache: bool = False):
    """Full-sequence recurrent mixer. x [B, S, D] -> [B, S, D].  With
    ``return_cache``, returns ``(y, cache)``: the decode cache after the
    last step, i.e. the conv window (the last W - 1 conv inputs, zeros
    before the sequence's start) and the recurrence's final state."""
    y, cache = rglru_inner(params, x, return_cache=return_cache)
    y = y @ params["wo"]
    return (y, cache) if return_cache else y


def init_rglru_cache(d_rnn: int, conv_width: int, batch: int, dtype, device) -> dict:
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype, device=device),
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
    }


def rglru_decode_inner(params: dict, cache: dict, x: torch.Tensor):
    """One token ``x [B, 1, D]`` through the mixer up to its
    out-projection: ``(y [B, R], new cache)``; the channels are
    ``params``'."""
    xt = x[:, 0]
    u1 = xt @ params["in1"]  # [B, R]
    u2 = F.gelu(xt @ params["in2"], approximate="tanh")
    window = torch.cat([cache["conv"], u1[:, None]], dim=1)  # [B, W, R]
    u1c = torch.einsum("bwr,wr->br", window.to(torch.float32),
                       params["conv"].to(torch.float32)).to(x.dtype)
    a, w = _gates(params, u1c)
    h = a * cache["h"] + w
    return h.to(x.dtype) * u2, {"conv": window[:, 1:], "h": h}


def rglru_decode_step(params: dict, cache: dict, x: torch.Tensor):
    """One-token step. x [B, 1, D] -> (y [B, 1, D], new cache)."""
    y, new = rglru_decode_inner(params, cache, x)
    return (y @ params["wo"])[:, None], new
