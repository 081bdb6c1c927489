"""Plain PyTorch versions of the port's kernels.

Each ``*_ref`` computes what its kernel computes, with torch ops, on any
device: the wrappers run it for CPU tensors, the CPU tests hold it against
the JAX package, and ``chip_smoke.py`` holds each kernel against it on the
card.  Mirrors ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import CHUNK


def segment_reduce_sorted_ref(
    feats: torch.Tensor,  # [n, D] f32 or bf16
    src: torch.Tensor,  # [m] int, edges grouped by segment
    w: torch.Tensor,  # [m] f32
    seg_offsets: torch.Tensor,  # [s + 1] int, offsets[0] = 0, offsets[s] = m
) -> torch.Tensor:
    """``out[s] = Σ_{e ∈ [off[s], off[s+1])} w[e]·feats[src[e]]`` in f32;
    edges whose source lies outside ``[0, n)`` add nothing."""
    n, d = feats.shape
    num_seg = seg_offsets.numel() - 1
    counts = (seg_offsets[1:] - seg_offsets[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_seg, device=feats.device), counts
    )
    src = src.long()
    valid = (src >= 0) & (src < n)
    out = torch.zeros((num_seg, d), dtype=torch.float32, device=feats.device)
    if n == 0 or not bool(valid.any()):
        return out
    msgs = feats[src.clamp(0, n - 1)].float() * w.float()[:, None]
    msgs = torch.where(valid[:, None], msgs, torch.zeros((), device=feats.device))
    return out.index_add_(0, seg, msgs)


def edge_block_spmm_ref(
    feats: torch.Tensor,  # [V_src, D]
    src: torch.Tensor,  # [E] int, indices into feats rows
    dst: torch.Tensor,  # [E] int, indices into output rows
    w: torch.Tensor,  # [E] float
    num_dst: int,
) -> torch.Tensor:
    """``out[dst[e]] += w[e]·feats[src[e]]`` as ``[num_dst, D]`` f32.
    Edges with a source or destination out of range (the ``-1`` padding
    sentinel) add nothing, as in the TPU kernel."""
    n, d = feats.shape
    src, dst = src.long(), dst.long()
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < num_dst)
    src, dst, w = src[keep], dst[keep], w[keep]
    msgs = feats[src].float() * w.float()[:, None]
    out = torch.zeros((num_dst, d), dtype=torch.float32, device=feats.device)
    return out.index_add_(0, dst, msgs)


def fused_graduate_ref(
    x: torch.Tensor,  # [N, K]
    w: torch.Tensor,  # [K, M]
    b: torch.Tensor,  # [M]
    activation: str = "relu",
) -> torch.Tensor:
    """``act(x @ w + b)`` accumulated in f32, returned in ``x.dtype``;
    gelu is the tanh approximation (``jax.nn.gelu``'s default)."""
    out = x.float() @ w.float() + b.float()
    if activation == "relu":
        out = torch.relu(out)
    elif activation == "gelu":
        out = F.gelu(out, approximate="tanh")
    elif activation != "none":
        raise ValueError(activation)
    return out.to(x.dtype)


ATT_EMPTY = -1e30  # the max a GAT partial with no edge carries: exp(ATT_EMPTY - m) == 0


def attention_scores_ref(
    z: torch.Tensor,  # [n, H·F] (a view with row stride allowed)
    a_src: torch.Tensor,  # [H, F]
    a_dst: torch.Tensor,  # [H, F]
) -> tuple[torch.Tensor, torch.Tensor]:
    """GAT's per-vertex scores ``(s, t)``, each ``[n, H]``:
    ``s_v^h = <a_src^h, z_v^h>``, ``t_v^h = <a_dst^h, z_v^h>``."""
    heads, f = a_src.shape
    zh = z.reshape(z.shape[0], heads, f)
    return (zh * a_src).sum(-1), (zh * a_dst).sum(-1)


def _segment_ids(offsets: torch.Tensor) -> torch.Tensor:
    """Each entry's segment for entries ``[0, offsets[-1])`` grouped by
    ``offsets`` (``offsets[0] == 0``)."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(counts.numel(), device=offsets.device), counts)


def segment_attention_ref(
    z: torch.Tensor,  # [n, H·F]
    s: torch.Tensor,  # [n, H] source scores
    t_seg: torch.Tensor,  # [segments, H] each segment's destination score
    src: torch.Tensor,  # [m] int, grouped by segment
    offsets: torch.Tensor,  # [segments + 1] int, offsets[0] = 0
    slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GAT's attention partials per segment and head, ``(num, den, mx)``:
    ``mx`` the largest logit ``e = LeakyReLU(t_seg + s[src])`` over the
    segment's edges, ``den = Σ exp(e − mx)`` and ``num = Σ exp(e − mx)·
    z[src]`` (``[segments, H·F]``), in ``z``'s dtype.  Edges whose source
    lies outside ``[0, n)`` add nothing; a segment with none has ``mx =
    ATT_EMPTY`` and zero sums."""
    n, heads = s.shape
    f = z.shape[1] // heads
    num_seg = offsets.numel() - 1
    seg = _segment_ids(offsets)
    u = src[: seg.numel()].long()
    keep = (u >= 0) & (u < n)
    seg, u = seg[keep], u[keep]
    e = F.leaky_relu(t_seg[seg] + s[u], slope)
    mx = torch.full((num_seg, heads), ATT_EMPTY, dtype=z.dtype, device=z.device)
    mx = mx.scatter_reduce(0, seg[:, None].expand(-1, heads), e, "amax", include_self=True)
    w = torch.exp(e - mx[seg])
    den = torch.zeros((num_seg, heads), dtype=z.dtype, device=z.device).index_add_(0, seg, w)
    msgs = (z[u].reshape(-1, heads, f) * w[:, :, None]).reshape(-1, heads * f)
    num = torch.zeros((num_seg, heads * f), dtype=z.dtype, device=z.device)
    return num.index_add_(0, seg, msgs), den, mx


def attention_normalize_ref(
    num: torch.Tensor,  # [R, H·F] partials, as segment_attention_ref gives them
    den: torch.Tensor,  # [R, H]
    mx: torch.Tensor,  # [R, H]
    rows: torch.Tensor,  # [k] int, each destination's partial rows in order
    offsets: torch.Tensor,  # [nv + 1] int, offsets[0] = 0
    bias: torch.Tensor,  # [H·F]
    concat: bool,
    elu: bool,
    scale: float = 1.0,
    skip: torch.Tensor | None = None,  # [nv, H·F], concat only
) -> torch.Tensor:
    """Each destination's partials rescaled to their largest max and summed,
    ``y = num / den`` (0 where ``den`` is 0), plus ``bias``; with
    ``concat`` the heads side by side ``[nv, H·F]``, plus ``skip``, through
    ELU if ``elu``; else ``scale`` times the sum over heads, ``[nv, F]``."""
    heads = den.shape[1]
    f = num.shape[1] // heads
    nv = offsets.numel() - 1
    dst = _segment_ids(offsets)
    r = rows[: dst.numel()].long()
    m = torch.full((nv, heads), ATT_EMPTY, dtype=num.dtype, device=num.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, heads), mx[r], "amax", include_self=True)
    c = torch.exp(mx[r] - m[dst])
    d = torch.zeros((nv, heads), dtype=num.dtype, device=num.device).index_add_(0, dst, c * den[r])
    acc = torch.zeros((nv, heads * f), dtype=num.dtype, device=num.device)
    acc.index_add_(0, dst, (num[r].reshape(-1, heads, f) * c[:, :, None]).reshape(-1, heads * f))
    safe = torch.where(d > 0, d, torch.ones_like(d))
    y = torch.where((d > 0)[:, :, None], acc.reshape(nv, heads, f) / safe[:, :, None],
                    torch.zeros((), dtype=num.dtype, device=num.device))
    y = y + bias.reshape(heads, f)
    if not concat:
        if skip is not None:
            raise ValueError("a skip is added only to concatenated heads")
        return y.sum(1) * scale
    y = y.reshape(nv, heads * f)
    if skip is not None:
        y = y + skip
    return F.elu(y) if elu else y


NEG_INF = -1e30  # the TPU kernel's finite mask value: exp(NEG_INF - m) == 0


def attention_mask(s: int, causal: bool, window: int | None, device) -> torch.Tensor | None:
    """``[S, S]`` bool, True where query ``q`` sees key ``k``: ``k <= q``
    when causal, and ``q - k < window`` with a window (the JAX package's
    ``_attn_mask``); None when every key is visible."""
    if not causal and window is None:
        return None
    pos = torch.arange(s, device=device)
    diff = pos[:, None] - pos[None, :]  # q - k
    mask = torch.ones(s, s, dtype=torch.bool, device=device)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Causal or full GQA attention as ``_flash_kernel`` computes it, with
    an optional sliding window (``attention_mask``): the scores, softmax
    and probabilities stay in f32 (the probabilities are not rounded to
    ``v.dtype``), masked scores are ``NEG_INF``, a row whose sum is 0
    outputs 0, and query head ``h`` reads KV head ``h // group``.
    Returns ``q.dtype``."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (1.0 / d**0.5)
    mask = attention_mask(s, causal, window, q.device)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l
    return out.reshape(b, hq, s, d).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores in f32,
    ``[B·Hq, S]``: what K3's forward writes for the backward."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (1.0 / d**0.5)
    mask = attention_mask(s, causal, window, q.device)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    return torch.logsumexp(scores, dim=-1).reshape(b * hq, s)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [B, Hq, S, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    out: torch.Tensor,  # [B, Hq, S, D], the forward's output
    dout: torch.Tensor,  # [B, Hq, S, D]
    causal: bool = True,
    window: int | None = None,
):
    """The gradient of ``flash_attention_ref`` as K3's backward computes
    it: ``P`` recomputed from the scores, ``delta = rowsum(dO∘O)`` from the
    forward's output as given (rounded to its dtype), ``dS = P∘(dO·Vᵀ −
    delta)``, ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q`` and ``dV =
    Pᵀ·dO``, each KV head summing over its group of query heads; the mask
    is the forward's.  Computed in f64 from the inputs: where dK and dV
    sum a group of 16 heads over a band of 2048 queries (recurrentgemma),
    an f32 version missed an f64 gradient by more than the f32 bar of
    1e-5 while K3's backward, whose f32 chains are shorter, stayed within
    it (on an NVIDIA H100 80GB HBM3 at 700 W).  Returns ``(dq, dk, dv)``
    in the inputs' dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    sm = 1.0 / d**0.5
    qg = q.double().reshape(b, hkv, g, s, d)
    dog = dout.double().reshape(b, hkv, g, s, d)
    kf, vf = k.double(), v.double()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * sm
    mask = attention_mask(s, causal, window, q.device)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    delta = (dout.double() * out.double()).sum(-1).reshape(b, hkv, g, s, 1)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sm
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * sm
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_ref(
    x: torch.Tensor,  # [BH, S, P]
    a: torch.Tensor,  # [BH, S] per-step decay in (0, 1]
    b: torch.Tensor,  # [BH // heads_per_bc, S, N]
    c: torch.Tensor,  # [BH // heads_per_bc, S, N]
    chunk: int = 256,
    heads_per_bc: int = 1,
    return_state: bool = False,
):
    """Mamba-2 SSD scan in its chunked form, all in f32, as ``_ssd_kernel``
    computes it: per chunk ``(L∘CBᵀ)X + exp(cumlog a)·C·stateᵀ`` with the
    ``[P, N]`` state carried from chunk to chunk.  Sequence ``i`` reads
    ``b``/``c`` row ``i // heads_per_bc``.  Returns ``x.dtype``, and with
    ``return_state`` also the f32 state after the last step."""
    bh, s, p = x.shape
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}")
    idx = torch.arange(bh, device=x.device) // heads_per_bc
    xf, af = x.float(), a.float()
    bf, cf = b.float()[idx], c.float()[idx]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(bh, p, b.shape[-1], dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        xk, bk, ck = (t[:, c0:c0 + chunk] for t in (xf, bf, cf))
        cl = torch.cumsum(torch.log(af[:, c0:c0 + chunk]), dim=1)  # [BH, T]
        diff = cl[:, :, None] - cl[:, None, :]
        lmat = torch.exp(diff.masked_fill(~tril, 0.0)).masked_fill(~tril, 0.0)
        g = (ck @ bk.transpose(1, 2)) * lmat  # [BH, T, T]
        y = g @ xk + torch.exp(cl)[..., None] * (ck @ state.transpose(1, 2))
        ys.append(y)
        w = torch.exp(cl[:, -1:] - cl)[..., None]  # [BH, T, 1]
        state = state * torch.exp(cl[:, -1])[:, None, None] + (w * xk).transpose(1, 2) @ bk
    y = torch.cat(ys, dim=1).to(x.dtype)
    return (y, state) if return_state else y


def ssd_scan_bwd_ref(
    x: torch.Tensor,  # [BH, S, P]
    a: torch.Tensor,  # [BH, S]
    b: torch.Tensor,  # [BH // heads_per_bc, S, N]
    c: torch.Tensor,  # [BH // heads_per_bc, S, N]
    dy: torch.Tensor,  # [BH, S, P]
    chunk: int = 256,
    heads_per_bc: int = 1,
):
    """The gradient of ``ssd_scan_ref`` as K4's backward computes it, all
    in f32, chunk by chunk with the state gradient ``dS`` carried
    backwards.  Within a chunk, with ``cl`` the cumsum of ``log a``,
    ``L[t,s] = exp(cl_t − cl_s)`` on and below the diagonal, ``G = C Bᵀ``,
    ``w_s = exp(cl_T − cl_s)`` and ``S_in`` the chunk's input state:
    ``dX = (L∘G)ᵀ dY + diag(w) B dSᵀ``, ``dC = (L∘dY Xᵀ) B + diag(e^cl)
    dY S_in``, ``dB = (L∘dY Xᵀ)ᵀ C + diag(w) X dS``, ``dS_in = e^{cl_T} dS
    + (diag(e^cl) dY)ᵀ C``, and ``dcl`` from the masked products, the
    readout, the state's decay and the weights ``w``; ``d log a`` is the
    reverse cumsum of ``dcl`` in the chunk.  ``db`` and ``dc`` sum the
    heads that share a row.  Returns ``(dx, da, db, dc)`` in the inputs'
    dtypes."""
    bh, s, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}")
    idx = torch.arange(bh, device=x.device) // heads_per_bc
    xf, af, dyf = x.float(), a.float(), dy.float()
    bf, cf = b.float()[idx], c.float()[idx]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    starts = range(0, s, chunk)
    cls, states = [], []
    state = torch.zeros(bh, p, n, dtype=torch.float32, device=x.device)
    for c0 in starts:  # the input state of every chunk
        cl = torch.cumsum(torch.log(af[:, c0:c0 + chunk]), dim=1)
        cls.append(cl)
        states.append(state)
        w = torch.exp(cl[:, -1:] - cl)[..., None]
        state = (state * torch.exp(cl[:, -1])[:, None, None]
                 + (w * xf[:, c0:c0 + chunk]).transpose(1, 2) @ bf[:, c0:c0 + chunk])
    dx, dloga, db, dc = (torch.empty_like(t) for t in (xf, af, bf, cf))
    ds = torch.zeros_like(state)
    for k in reversed(range(len(starts))):
        sl = slice(starts[k], starts[k] + chunk)
        xk, bk, ck, dyk = xf[:, sl], bf[:, sl], cf[:, sl], dyf[:, sl]
        cl, s_in = cls[k], states[k]
        diff = cl[:, :, None] - cl[:, None, :]
        lmat = torch.exp(diff.masked_fill(~tril, 0.0)).masked_fill(~tril, 0.0)
        dyx = dyk @ xk.transpose(1, 2)  # [BH, T, T]
        lg = lmat * (ck @ bk.transpose(1, 2))
        ld = lmat * dyx
        m = lg * dyx
        e = torch.exp(cl)  # [BH, T]
        w = torch.exp(cl[:, -1:] - cl)
        xds = xk @ ds  # X dS, [BH, T, N]
        dys = dyk @ s_in  # dY S_in, [BH, T, N]
        dx[:, sl] = lg.transpose(1, 2) @ dyk + w[..., None] * (bk @ ds.transpose(1, 2))
        dc[:, sl] = ld @ bk + e[..., None] * dys
        db[:, sl] = ld.transpose(1, 2) @ ck + w[..., None] * xds
        wq = w * (bk * xds).sum(-1)  # w_s ⟨dS, x_s b_sᵀ⟩
        dcl = m.sum(2) - m.sum(1) + e * (ck * dys).sum(-1) - wq
        dcl[:, -1] += torch.exp(cl[:, -1]) * (ds * s_in).sum((1, 2)) + wq.sum(1)
        dloga[:, sl] = dcl.flip(1).cumsum(1).flip(1)
        ds = torch.exp(cl[:, -1])[:, None, None] * ds + (e[..., None] * dyk).transpose(1, 2) @ ck
    rows = bh // heads_per_bc
    db = db.reshape(rows, heads_per_bc, s, n).sum(1)
    dc = dc.reshape(rows, heads_per_bc, s, n).sum(1)
    return dx.to(x.dtype), (dloga / af).to(a.dtype), db.to(b.dtype), dc.to(c.dtype)


def _chunked_walk(
    x: torch.Tensor,  # [B, N, R] f32 multipliers
    y: torch.Tensor,  # [B, N, R] f32 addends
    init: torch.Tensor,  # [B, R] f32 state before step 0
    chunk: int | None,
) -> torch.Tensor:
    """``s_i = x_i·s_{i-1} + y_i`` over axis 1 from ``init``, every product
    and sum one f32 op (no fused multiply-add), in K6's chunked order: for
    chunks of ``chunk`` steps (the last one ragged), ``A_j`` = the chunk's
    ``x`` multiplied left to right and ``H_j`` = the chunk walked from +0;
    ``c_0 = init``, ``c_{j+1} = A_j·c_j + H_j``; then each chunk walked from
    its ``c_j``.  ``chunk`` None or ``>= N`` is one chunk: the sequential
    loop.  Every chunk's steps run at once, vectorized over chunks."""
    b, n, r = x.shape
    chunk = n if chunk is None else min(chunk, n)
    k = -(-n // chunk)
    pad = (0, 0, 0, k * chunk - n)  # the ragged chunk's missing steps: no output, no carry
    xc = F.pad(x, pad).view(b, k, chunk, r)
    yc = F.pad(y, pad).view(b, k, chunk, r)
    # 1·x_0 is x_0 and x_0·(+0) + y_0 is the walk's first step from +0
    agg_a, agg_h = torch.ones_like(xc[:, :-1, 0]), torch.zeros_like(xc[:, :-1, 0])
    for i in range(chunk):  # the last chunk carries into nothing
        agg_a = agg_a * xc[:, :-1, i]
        agg_h = xc[:, :-1, i] * agg_h + yc[:, :-1, i]
    carries = [init]
    for j in range(k - 1):
        carries.append(agg_a[:, j] * carries[-1] + agg_h[:, j])
    s = torch.stack(carries, 1)
    out = torch.empty_like(xc)
    for i in range(chunk):
        s = xc[:, :, i] * s + yc[:, :, i]
        out[:, :, i] = s
    return out.view(b, k * chunk, r)[:, :n].contiguous()


def rglru_scan_ref(
    a: torch.Tensor,  # [B, S, R] f32 decays
    w: torch.Tensor,  # [B, S, R] f32 inputs
    h0: torch.Tensor | None = None,  # [B, R] f32 carried state
    chunk: int | None = CHUNK,
) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t·h_{t-1} + w_t`` over axis 1 as K6
    computes it, from ``h0`` (or +0): S cut into chunks of ``chunk`` steps,
    each chunk's decay product ``A_j`` (left to right) and its walk ``H_j``
    from +0, the carries ``c_{j+1} = A_j·c_j + H_j`` in chunk order, then
    each chunk walked from ``c_j``; every step one f32 product and then one
    f32 sum.  ``chunk=None`` (or ``>= S``) is the sequential loop.
    Returns ``h`` ``[B, S, R]`` f32."""
    init = torch.zeros_like(a[:, 0]) if h0 is None else h0
    return _chunked_walk(a, w, init, chunk)


def rglru_scan_bwd_ref(
    a: torch.Tensor,  # [B, S, R] f32
    h: torch.Tensor,  # [B, S, R] f32, the forward's output
    dh: torch.Tensor,  # [B, S, R] f32
    h0: torch.Tensor | None = None,  # [B, R] f32
    chunk: int | None = CHUNK,
):
    """The gradient of ``rglru_scan_ref`` as K6's backward computes it: the
    reverse recurrence ``g_t = dh_t + a_{t+1}·g_{t+1}`` (``g_{S-1} =
    dh_{S-1}``) as the forward's chunked walk over reversed time, with
    multipliers ``a_{t+1}`` (0 at t = S-1) and the initial state -0 (so the
    first step is ``dh_{S-1}`` bit for bit), chunks counted from t = S-1;
    then ``dw_t = g_t``, ``da_t = g_t·h_{t-1}`` with ``h_{-1} = h0`` (or 0)
    and ``dh0 = a_0·g_0``.  ``chunk=None`` (or ``>= S``) is the sequential
    loop downwards.  Returns ``(da, dw, dh0)``, ``dh0`` None without ``h0``."""
    x = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1).flip(1)
    init = torch.full_like(a[:, 0], -0.0)
    g = _chunked_walk(x, dh.flip(1), init, chunk).flip(1)
    prev = torch.cat([torch.zeros_like(a[:, :1]) if h0 is None else h0[:, None], h[:, :-1]], 1)
    return g * prev, g, (None if h0 is None else a[:, 0] * g[:, 0])


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·(1 + scale)`` over the last axis, in f32,
    returned in ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def rms_norm_bwd_ref(
    x: torch.Tensor,  # [N, D]
    scale: torch.Tensor,  # [D]
    dy: torch.Tensor,  # [N, D]
    eps: float = 1e-6,
):
    """The gradient of ``rms_norm_ref`` as K5's backward computes it, in
    f32 with ``r = rsqrt(mean(x²) + eps)``: ``dx = r·(1+s)·dy −
    x·r³·mean(x·(1+s)·dy)`` and ``dscale = Σ_rows dy·x·r``.  Returns
    ``(dx, dscale)`` in the dtypes of ``x`` and ``scale``."""
    xf, gf = x.float(), dy.float()
    w = 1.0 + scale.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    c = r * r * r * torch.mean(xf * w * gf, dim=-1, keepdim=True)
    dx = r * w * gf - xf * c
    dscale = (gf * (xf * r)).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
