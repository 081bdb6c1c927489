"""Mixture-of-Experts layer (deepseek-moe-16b, arctic-480b), ported from
``repro/models/moe.py``.

The reference's group-local capacity formulation: tokens are grouped by
batch row; routing runs in f32 (softmax, the top-k experts of each token,
renormalized); per (group, expert) the ``C`` tokens with the largest gates
win a slot (``C = moe_capacity(...)``), the rest of a full expert's tokens
are dropped.  The selections are stable descending sorts cut to their first
k or ``C``, which puts the lower index first on ties as ``jax.lax.top_k``
does (every unrouted token scores ``-1``, so ties are the rule there).

Dispatch and combine are a permutation pair: ``slot_tok`` maps each slot
to its token (a zero row for a slot that no routed token fills), and the
inverse map takes each token to its valid slots (at most ``top_k``, in
expert order, padded with a zero row).  Dispatch gathers through the
first, combine gathers through the second and adds a token's slots in
expert order in ``ye.dtype`` (the order of the reference's ``.at[].add``
from zeros); each direction's backward is a gather through the other
map, so no float scatter-add or atomic is ever needed.  The expert SwiGLU
is three batched products (``torch.einsum``), as the reference leaves it
to XLA.  Shared experts (deepseek) and the dense residual (arctic) are
ordinary MLPs added by ``models/lm.py``.

``moe_forward`` is ``moe_route`` (the routing and the slot map), its
inverse (``slot_inverse``), then ``moe_experts`` (dispatch, the experts,
combine).  The sharded steps (``distributed/spmd.py``) call them apart:
the routing once, then each model position's experts on its columns of
the slot map, with the inverse over its own experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def moe_capacity(seq: int, num_experts: int, top_k: int, factor: float) -> int:
    c = int(-(-seq * top_k * factor // num_experts))
    c = max(8, -(-c // 8) * 8)  # round up to a multiple of 8
    return min(c, seq)  # decode: cannot select more slots than tokens


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int, dtype,
             device) -> dict:
    """The reference's distributions: a ``N(0, 1/d_model)`` f32 router and
    per-expert ``gate``/``up`` (``N(0, 1/d_model)``) and ``down``
    (``N(0, 1/d_ff)``) in ``dtype``, drawn one expert at a time, so no f32
    copy of a whole leaf is ever held (arctic's ``gate`` has 4.46 G values)."""

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        out = torch.empty((num_experts, d_in, d_out), dtype=dtype, device=device)
        for e in range(num_experts):
            out[e] = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                                 device=device) * (1.0 / d_in) ** 0.5
        return out

    return {
        "router": dense_init(gen, d_model, num_experts, torch.float32, device),
        "gate": experts(d_model, d_ff),
        "up": experts(d_model, d_ff),
        "down": experts(d_ff, d_model),
    }


def _top(scores: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, lower index first on ties."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, R, D]`` with a zero row appended, gathered at ``idx [B, M, K]``
    (``R`` picks the zero row) and summed over ``K`` in order in
    ``x.dtype``: ``[B, M, D]`` (the reference's sum from zeros, whose first
    add is exact)."""
    b, _, d = x.shape
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    out = torch.gather(xp, 1, idx[:, :, 0, None].expand(-1, -1, d))
    for j in range(1, idx.shape[2]):
        out = out + torch.gather(xp, 1, idx[:, :, j, None].expand(-1, -1, d))
    return out


class _Dispatch(torch.autograd.Function):
    """``x [B, S, D]`` -> ``xe [B, E·C, D]`` through ``slot_tok``; the
    backward adds each token's slots in expert order through ``inv``."""

    @staticmethod
    def forward(ctx, x, slot_tok, inv):
        ctx.save_for_backward(slot_tok, inv)
        return _gather_rows(x, slot_tok[..., None])

    @staticmethod
    def backward(ctx, dxe):
        slot_tok, inv = ctx.saved_tensors
        return _gather_rows(dxe, inv), None, None


class _Combine(torch.autograd.Function):
    """``ye [B, E·C, D]`` -> ``out [B, S, D]`` through ``inv``; the backward
    gathers each slot's token gradient through ``slot_tok``."""

    @staticmethod
    def forward(ctx, ye, slot_tok, inv):
        ctx.save_for_backward(slot_tok, inv)
        return _gather_rows(ye, inv)

    @staticmethod
    def backward(ctx, dout):
        slot_tok, inv = ctx.saved_tensors
        return _gather_rows(dout, slot_tok[..., None]), None, None


def slot_inverse(fwd: torch.Tensor, s: int, top_k: int) -> torch.Tensor:
    """The inverse of ``fwd [B, M]`` (each slot's token, ``s`` where none
    fills it): each token's valid slots in slot order, ``M`` (the zero row)
    past them, ``[B, S, top_k]`` (a token is routed to ``top_k`` experts and
    holds at most one slot of each).  Given the slots of some of the
    experts, it is the inverse over those experts alone."""
    b, width = fwd.shape
    keys, order = torch.sort(fwd, dim=1, stable=True)  # slots by token, expert order kept
    tok = torch.arange(s, device=fwd.device).expand(b, s).contiguous()
    start = torch.searchsorted(keys, tok)
    end = torch.searchsorted(keys, tok, right=True)
    pos = start[..., None] + torch.arange(top_k, device=fwd.device)  # [B, S, K]
    slot = torch.gather(order, 1, pos.clamp(max=width - 1).reshape(b, -1)).reshape(pos.shape)
    return torch.where(pos < end[..., None], slot, width)


def moe_route(router: torch.Tensor, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25) -> tuple:
    """Routing in f32, the top-k experts of each token and the capacity
    selection of ``x [B, S, D]``: the slot maps ``fwd [B, E·C]`` and
    ``inv [B, S, top_k]`` (``_slot_maps``) and each slot's gate
    ``slot_gate [B, E, C]`` f32 (0 where the slot is empty), through which
    the router's gradient flows."""
    b, s, _ = x.shape
    e = router.shape[1]
    cap = moe_capacity(s, e, top_k, capacity_factor)

    probs = torch.softmax(x.float() @ router, dim=-1)  # [B, S, E]
    top_vals, top_idx = _top(probs, top_k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)  # renorm
    gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)

    # --- per-(group, expert) capacity selection ----------------------------
    scores = torch.where(gates > 0.0, gates, -1.0).transpose(1, 2)  # [B, E, S]
    slot_gate, slot_tok = _top(scores, cap)  # [B, E, C]
    valid = slot_gate > 0.0
    slot_gate = torch.where(valid, slot_gate, 0.0)

    return torch.where(valid, slot_tok, s).reshape(b, e * cap), slot_gate


def moe_experts(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, x: torch.Tensor,
                fwd: torch.Tensor, inv: torch.Tensor, slot_gate: torch.Tensor) -> torch.Tensor:
    """Dispatch, the expert SwiGLU and combine for the ``E'`` experts whose
    leaves are given (``gate``/``up`` ``[E', D, F]``, ``down`` ``[E', F, D]``),
    with their columns of the slot maps (``fwd [B, E'·C]``, ``inv`` over
    those slots) and of ``slot_gate [B, E', C]``: ``[B, S, D]`` in
    ``x.dtype``, each token's slots added in expert order."""
    b, _, d = x.shape
    e, cap = slot_gate.shape[1:]
    xe = _Dispatch.apply(x, fwd, inv).reshape(b, e, cap, d)
    h = F.silu(torch.einsum("becd,edf->becf", xe, gate)) * torch.einsum("becd,edf->becf", xe, up)
    ye = torch.einsum("becf,efd->becd", h, down)  # [B, E, C, D]
    ye = ye * slot_gate[..., None].to(ye.dtype)
    out = _Combine.apply(ye.reshape(b, e * cap, d), fwd, inv)
    return out.to(x.dtype)


def moe_forward(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
) -> torch.Tensor:
    fwd, slot_gate = moe_route(params["router"], x, top_k, capacity_factor)
    inv = slot_inverse(fwd, x.shape[1], top_k)
    return moe_experts(params["gate"], params["up"], params["down"], x, fwd, inv, slot_gate)


def moe_aux_loss(x: torch.Tensor, router: torch.Tensor, top_k: int) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f·P)."""
    probs = torch.softmax(x.float() @ router, dim=-1)  # [B, S, E]
    e = probs.shape[-1]
    _, top_idx = _top(probs, top_k)
    frac = F.one_hot(top_idx, e).float().mean(dim=(0, 1, 2))
    imp = probs.mean(dim=(0, 1))
    return e * torch.sum(frac * imp)
