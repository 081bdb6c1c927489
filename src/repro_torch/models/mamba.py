"""Mamba-2 block (SSD, state-space duality), ported from ``repro/models/mamba.py``.

Projections are stored per component (z / x / B / C / dt), as in the JAX
package.  The full-sequence path (prefill and training) runs the chunked
SSD scan as K4 with B and C shared by all heads (ngroups = 1); under
autograd on the card its gradient is K4's backward kernel
(``ops.ssd``).  The decode path is the O(1) recurrent state update in
plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm


def init_mamba_block(
    gen: torch.Generator, d_model: int, d_state: int, head_dim: int, conv_width: int,
    dtype, device,
) -> dict:
    d_inner = 2 * d_model
    nheads = d_inner // head_dim
    f32 = dict(dtype=torch.float32, device=device)
    conv = torch.randn((conv_width, d_inner), generator=gen, **f32) * 0.1
    return {
        "wz": dense_init(gen, d_model, d_inner, dtype, device),
        "wx": dense_init(gen, d_model, d_inner, dtype, device),
        "wb": dense_init(gen, d_model, d_state, dtype, device),
        "wc": dense_init(gen, d_model, d_state, dtype, device),
        "wdt": dense_init(gen, d_model, nheads, dtype, device),
        "conv_x": conv.to(dtype),
        "a_log": torch.zeros((nheads,), **f32),
        "d_skip": torch.ones((nheads,), **f32),
        "dt_bias": torch.zeros((nheads,), **f32),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=device),
        "wo": dense_init(gen, d_inner, d_model, dtype, device),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in f32. x [B, S, C], w [W, C]."""
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):  # width is tiny (4): unrolled adds
        out = out + xp[:, i : i + s].to(torch.float32) * w[i].to(torch.float32)
    return out.to(x.dtype)


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]  (dt already folded into x)
    a: torch.Tensor,  # [B, S, H]     per-step decay in (0, 1]
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    chunk: int = 256,
    return_state: bool = False,
):
    """Chunked SSD scan (K4).  ``chunk = min(chunk, S)`` and ``S`` must be a
    multiple of it: padding a recurrence would change its state.  With
    ``return_state``, also the f32 state ``[B, H, P, N]`` after the last step."""
    b, s, h, p = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {chunk}")
    xs = x.permute(0, 2, 1, 3).reshape(b * h, s, p).contiguous()
    As = a.permute(0, 2, 1).reshape(b * h, s).contiguous()
    out = ops.ssd(xs, As, bmat.contiguous(), cmat.contiguous(), chunk, heads_per_bc=h,
                  return_state=return_state)
    y, state = out if return_state else (out, None)
    y = y.reshape(b, h, s, p).permute(0, 2, 1, 3)
    return (y, state.reshape(b, h, p, -1)) if return_state else y


def mamba_inner(params: dict, x: torch.Tensor, *, head_dim: int, chunk: int = 256,
                return_cache: bool = False):
    """The mixer on ``x [B, S, D]`` up to its gated norm: ``(y, z, cache)``,
    ``y [B, S, di]`` the SSD output with its skip, ``z`` the gate's input,
    ``cache`` as ``mamba_forward``'s (None without ``return_cache``).
    The heads are those of ``params``' columns: the sharded step gives
    each model position its own (``distributed/spmd.py``)."""
    b, s, _ = x.shape
    z = x @ params["wz"]  # [B, S, di]
    xraw = x @ params["wx"]
    bproj = x @ params["wb"]  # [B, S, N]
    cproj = x @ params["wc"]
    dt = x @ params["wdt"]  # [B, S, H]

    xin = F.silu(causal_conv1d(xraw, params["conv_x"]))
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # [B, S, H]
    a = torch.exp(-torch.exp(params["a_log"]) * dt)  # (0, 1)

    h = xin.shape[-1] // head_dim
    xh = xin.reshape(b, s, h, head_dim)
    xd = xh * dt[..., None].to(xh.dtype)  # fold dt into the input
    y = ssd_chunked(xd, a, bproj, cproj, chunk=chunk, return_state=return_cache)
    y, state = y if return_cache else (y, None)
    y = y + params["d_skip"][None, None, :, None].to(y.dtype) * xh
    cache = ({"conv": xraw[:, -(params["conv_x"].shape[0] - 1):], "ssm": state}
             if return_cache else None)
    return y.reshape(b, s, -1), z, cache


def mamba_forward(params: dict, x: torch.Tensor, *, head_dim: int, chunk: int = 256,
                  return_cache: bool = False):
    """Full-sequence Mamba-2 mixer. x [B, S, D] -> [B, S, D].  With
    ``return_cache``, returns ``(y, cache)``: the decode cache after the
    last step, i.e. the conv window (the last W - 1 conv inputs) and K4's
    final SSM state."""
    y, z, cache = mamba_inner(params, x, head_dim=head_dim, chunk=chunk,
                              return_cache=return_cache)
    y = rms_norm(y, params["norm"]) * F.silu(z)
    out = y @ params["wo"]
    return (out, cache) if return_cache else out


# --------------------------------------------------------------- decode


def init_mamba_cache(
    d_model: int, d_state: int, head_dim: int, conv_width: int, batch: int, dtype, device,
) -> dict:
    d_inner = 2 * d_model
    nheads = d_inner // head_dim
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nheads, head_dim, d_state), dtype=torch.float32, device=device),
    }


def mamba_decode_inner(params: dict, cache: dict, x: torch.Tensor, *, head_dim: int):
    """One token ``x [B, 1, D]`` through the mixer up to its gated norm:
    ``(y [B, di], z [B, di], new cache)``; the heads are ``params``'."""
    b = x.shape[0]
    xt = x[:, 0]  # [B, D]
    z = xt @ params["wz"]
    xin = xt @ params["wx"]  # [B, di]
    bproj = xt @ params["wb"]  # [B, N]
    cproj = xt @ params["wc"]
    dt = xt @ params["wdt"]  # [B, H]

    # conv over the rolling window
    w = params["conv_x"]  # [W, di]
    window = torch.cat([cache["conv"], xin[:, None]], dim=1)  # [B, W, di]
    conv_out = torch.einsum("bwc,wc->bc", window.to(torch.float32), w.to(torch.float32))
    xin_c = F.silu(conv_out).to(x.dtype)
    new_conv = window[:, 1:]

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    a = torch.exp(-torch.exp(params["a_log"]) * dt)  # [B, H]
    h = xin_c.shape[-1] // head_dim
    xh = xin_c.reshape(b, h, head_dim)
    xd = xh.to(torch.float32) * dt[..., None]

    state = cache["ssm"]  # [B, H, P, N]
    state = state * a[..., None, None] + xd[..., None] * bproj[:, None, None, :].to(torch.float32)
    y = torch.einsum("bhpn,bn->bhp", state, cproj.to(torch.float32))
    y = y + params["d_skip"][None, :, None] * xh.to(torch.float32)
    return y.reshape(b, -1).to(x.dtype), z, {"conv": new_conv, "ssm": state}


def mamba_decode_step(params: dict, cache: dict, x: torch.Tensor, *, head_dim: int):
    """One-token step. x [B, 1, D] -> (y [B, 1, D], new cache)."""
    y, z, new = mamba_decode_inner(params, cache, x, head_dim=head_dim)
    y = rms_norm(y, params["norm"]) * F.silu(z)
    return (y @ params["wo"])[:, None], new
