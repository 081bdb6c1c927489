"""GAT's attention aggregation: scores, per-head softmax-weighted segment
sums, and their normalisation (``csrc/segment_attention.cu``).

Port-only (the JAX package has no GAT).  For a layer of H heads of F
features whose projected rows ``z`` (``[n, H·F]``) K2 has computed:

- ``attention_scores(z, a_src, a_dst)``: ``s_v^h = <a_src^h, z_v^h>`` and
  ``t_v^h = <a_dst^h, z_v^h>``, ``[n, H]`` each.
- ``segment_attention(z, s, t_seg, src, offsets)``: per segment of edges
  (grouped by destination, as K1 takes them) and head, the partial
  ``(num, den, mx)``: ``mx`` the largest logit ``e = LeakyReLU(t_seg +
  s[src])``, ``den = Σ exp(e − mx)``, ``num = Σ exp(e − mx)·z[src]``.
- ``attention_normalize(num, den, mx, rows, offsets, bias, ...)``: per
  destination, its partial rows (one per source shard on a mesh) rescaled
  to their largest max and summed in row order, ``y = num / den``, plus
  the bias, and then either the heads side by side plus the skip through
  ELU, or the mean over heads.

The softmax is exact over a destination's in-edges however they are
split, without a max computed before the sums (each partial carries its
own, and partials meet by ``exp(mx_i − max_j mx_j)``).  Segments of more
than L = ``SLAB_EDGES`` edges (K1's 2,048) are cut into slabs of L
consecutive edges that run side by side; their partials meet in slab
order.  Every sum runs in f32 in one fixed order (edge order within a
slab, slab order, row order, head order), with no float atomics, so a
run's bits depend on its inputs alone.

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch
the kernels or raise.  ``launches`` counts every kernel launched, and
``kernel_launches[name]`` each kernel's: ``scores``, ``sums`` (a
segment_attention call's slabs), ``combine`` (its second launch, where
a segment was cut into slabs), ``normalize``.  The card needs f32 rows of whole quads: ``F % 4
== 0``, ``F <= 512``, row strides a multiple of 4, 16-byte aligned.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (ATT_EMPTY: the callers' name for it)
    ATT_EMPTY,
    attention_normalize_ref,
    attention_scores_ref,
    segment_attention_ref,
)

SLAB_EDGES = 2048  # L: the kernel's kSlabEdges, K1's slab
MAX_F = 512  # widest head the kernels hold in registers
_INT32_MAX = 2**31 - 1

launches = _build.LaunchCount()
kernel_launches = {name: _build.LaunchCount()
                   for name in ("scores", "sums", "combine", "normalize")}


def _launched(*names: str) -> None:
    for name in names:
        launches.add()
        kernel_launches[name].add()


def slab_edges() -> int:
    """L as the built kernel has it (loads the library: needs the card's
    toolkit)."""
    return _build.load("segment_attention").atlas_segment_attention_slab_edges()


@dataclasses.dataclass(frozen=True)
class Slabs:
    """The aggregation's work table, from the offsets alone: ``table``
    ``[n, 4]`` int32 (segment, first edge, end edge, partial row or −1)
    per slab, in segment order and, within a segment, slab order (an empty
    segment is one empty slab); ``multis`` ``[k, 4]`` int32 (segment, first
    partial row, partial rows, 0) per segment cut into more than one slab;
    ``partials`` their slabs in all."""

    table: torch.Tensor
    multis: torch.Tensor
    partials: int

    def to(self, device) -> "Slabs":
        return Slabs(self.table.to(device), self.multis.to(device), self.partials)


def attention_slabs(offsets: torch.Tensor, slab: int = SLAB_EDGES) -> Slabs:
    """The slabs of the segments ``offsets`` (``[s + 1]``, non-decreasing,
    ``offsets[0] = 0``) delimit, on ``offsets``' device."""
    off = offsets.long()
    counts = (off[1:] - off[:-1]).clamp_min(0)
    per = ((counts + slab - 1) // slab).clamp_min(1)
    total = int(per.sum())
    dev = off.device
    seg = torch.repeat_interleave(torch.arange(per.numel(), device=dev), per, output_size=total)
    first = torch.cumsum(per, 0) - per
    lo = off[:-1][seg] + (torch.arange(total, device=dev) - first[seg]) * slab
    hi = torch.minimum(lo + slab, off[1:][seg])
    split = (per > 1)[seg]
    part = torch.full((total,), -1, dtype=torch.long, device=dev)
    partials = int(split.sum())
    part[split] = torch.arange(partials, device=dev)
    multi = torch.nonzero(per > 1).flatten()
    multis = torch.stack([multi, part[first[multi]], per[multi], torch.zeros_like(multi)], 1)
    table = torch.stack([seg, lo, hi, part], 1)
    return Slabs(table.to(torch.int32).contiguous(), multis.to(torch.int32).contiguous(),
                 partials)


def _card(name: str, *tensors) -> bool:
    """False for CPU tensors (the plain route); True for tensors on one CUDA
    device; raises otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors on the CPU or on one CUDA device")
    return True


def _rows_ok(name: str, t: torch.Tensor, width: int) -> None:
    """A card operand: f32 rows of at least ``width`` contiguous values, the
    row stride a multiple of 4 and the base 16-byte aligned."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] < width or (t.shape[0] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name} must be [n, >= {width}] with contiguous rows, got "
                         f"{tuple(t.shape)} strides {t.stride()}")
    if t.stride(0) % 4 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must start on 16 bytes (stride {t.stride(0)})")


def _head_width(f: int) -> None:
    if f <= 0 or f % 4 or f > MAX_F:
        raise ValueError(f"the card takes heads of whole quads up to {MAX_F} wide, got {f}")


def attention_scores(z: torch.Tensor, a_src: torch.Tensor,
                     a_dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, t)``, ``[n, H]`` f32 each, of ``z`` ``[n, H·F]`` (a column view
    of a wider tensor is taken as it is) against ``a_src``, ``a_dst``
    ``[H, F]``."""
    heads, f = a_src.shape
    if a_dst.shape != a_src.shape or z.dim() != 2 or z.shape[1] != heads * f:
        raise ValueError(f"z {tuple(z.shape)} against attention vectors {tuple(a_src.shape)}, "
                         f"{tuple(a_dst.shape)}")
    if not _card("attention_scores", z, a_src, a_dst):
        return attention_scores_ref(z, a_src, a_dst)
    _head_width(f)
    _rows_ok("z", z, heads * f)
    a_src, a_dst = a_src.contiguous(), a_dst.contiguous()
    for t in (a_src, a_dst):
        _rows_ok("attention vectors", t.view(1, -1), heads * f)
    n = z.shape[0]
    s = torch.empty((n, heads), dtype=torch.float32, device=z.device)
    t = torch.empty((n, heads), dtype=torch.float32, device=z.device)
    if n == 0:
        return s, t
    lib = _build.load("segment_attention")
    rc = lib.atlas_segment_attention_scores(_build.ptr(z), z.stride(0), _build.ptr(a_src),
                                            _build.ptr(a_dst), _build.ptr(s), _build.ptr(t), n,
                                            heads, f, _build.stream_handle(z.device))
    _build.check(rc, lib, "segment_attention")
    _launched("scores")
    return s, t


def segment_attention(
    z: torch.Tensor,  # [n, H·F] source rows (a column view allowed)
    s: torch.Tensor,  # [n, H] source scores
    t_seg: torch.Tensor,  # [segments, H] each segment's destination score
    src: torch.Tensor,  # [m] int32, grouped by segment
    offsets: torch.Tensor,  # [segments + 1] int32, offsets[0] = 0, non-decreasing
    slope: float = 0.2,
    slabs: Slabs | None = None,  # attention_slabs(offsets), if already made
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(num [segments, H·F], den [segments, H], mx [segments, H])`` f32:
    each segment's attention partials per head.  Sources outside ``[0, n)``
    add nothing; a segment with no edge gives ``mx = ATT_EMPTY``, zeros."""
    n, heads = s.shape
    f = z.shape[1] // heads if heads else 0
    num_seg = offsets.numel() - 1
    if z.dim() != 2 or z.shape[0] != n or z.shape[1] != heads * f or heads == 0:
        raise ValueError(f"z {tuple(z.shape)} and scores {tuple(s.shape)} disagree")
    if t_seg.shape != (num_seg, heads) or src.dim() != 1:
        raise ValueError(f"t_seg must be [{num_seg}, {heads}], got {tuple(t_seg.shape)}")
    if not _card("segment_attention", z, s, t_seg, src, offsets):
        return segment_attention_ref(z, s, t_seg, src, offsets, slope)
    _head_width(f)
    _rows_ok("z", z, heads * f)
    if src.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("src and offsets must be int32")
    if n > _INT32_MAX or src.numel() > _INT32_MAX:
        raise ValueError("n and m must be below 2**31 (int32 indices)")
    s, t_seg, src = s.float().contiguous(), t_seg.float().contiguous(), src.contiguous()
    if slabs is None:
        slabs = attention_slabs(offsets)
    dev = z.device
    num = torch.empty((num_seg, heads * f), dtype=torch.float32, device=dev)
    den = torch.empty((num_seg, heads), dtype=torch.float32, device=dev)
    mx = torch.empty((num_seg, heads), dtype=torch.float32, device=dev)
    if num_seg == 0:
        return num, den, mx
    p = slabs.partials
    pnum = torch.empty((p, heads * f), dtype=torch.float32, device=dev)
    pden = torch.empty((p, heads), dtype=torch.float32, device=dev)
    pmx = torch.empty((p, heads), dtype=torch.float32, device=dev)
    lib = _build.load("segment_attention")
    rc = lib.atlas_segment_attention(
        _build.ptr(z), z.stride(0), _build.ptr(s), _build.ptr(t_seg), _build.ptr(src),
        _build.ptr(slabs.table), slabs.table.shape[0], _build.ptr(slabs.multis),
        slabs.multis.shape[0], heads, f, n, float(slope), _build.ptr(num), _build.ptr(den),
        _build.ptr(mx), _build.ptr(pnum), _build.ptr(pden), _build.ptr(pmx),
        _build.stream_handle(dev))
    _build.check(rc, lib, "segment_attention")
    _launched("sums", *(("combine",) if slabs.multis.shape[0] else ()))
    return num, den, mx


def attention_normalize(
    num: torch.Tensor,  # [R, H·F] partial rows
    den: torch.Tensor,  # [R, H]
    mx: torch.Tensor,  # [R, H]
    rows: torch.Tensor,  # [k] int32: destination v's rows at rows[offsets[v]:offsets[v+1]]
    offsets: torch.Tensor,  # [nv + 1] int32
    bias: torch.Tensor,  # [H·F]
    *,
    concat: bool,
    elu: bool,
    scale: float = 1.0,
    skip: torch.Tensor | None = None,  # [nv, H·F] (a column view allowed), concat only
) -> torch.Tensor:
    """Each destination's output: ``[nv, H·F]`` (``concat``: ``y + bias +
    skip``, ELU if ``elu``) or ``[nv, F]`` (``scale·Σ_h (y^h + bias^h)``),
    f32, with ``y = Σ c·num / Σ c·den`` over its rows (``c = exp(mx −
    max mx)``; 0 where that is 0)."""
    heads = den.shape[1]
    f = num.shape[1] // heads if heads else 0
    nv = offsets.numel() - 1
    if num.shape != (den.shape[0], heads * f) or mx.shape != den.shape or heads == 0:
        raise ValueError(f"num {tuple(num.shape)}, den {tuple(den.shape)}, mx "
                         f"{tuple(mx.shape)} disagree")
    if bias.shape != (heads * f,):
        raise ValueError(f"bias must be [{heads * f}], got {tuple(bias.shape)}")
    if skip is not None and (not concat or skip.shape != (nv, heads * f)):
        raise ValueError(f"a skip is [{nv}, {heads * f}] and added to concatenated heads only")
    extra = () if skip is None else (skip,)
    if not _card("attention_normalize", num, den, mx, rows, offsets, bias, *extra):
        return attention_normalize_ref(num, den, mx, rows, offsets, bias, concat, elu, scale,
                                       skip)
    _head_width(f)
    for name, t in (("num", num), *((("skip", skip),) if skip is not None else ())):
        _rows_ok(name, t, heads * f)
    if rows.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("rows and offsets must be int32")
    den, mx = den.float().contiguous(), mx.float().contiguous()
    bias, rows = bias.float().contiguous(), rows.contiguous()
    out = torch.empty((nv, heads * f if concat else f), dtype=torch.float32, device=num.device)
    if nv == 0:
        return out
    lib = _build.load("segment_attention")
    rc = lib.atlas_segment_attention_normalize(
        _build.ptr(num), _build.ptr(den), _build.ptr(mx), _build.ptr(rows), _build.ptr(offsets),
        nv, _build.ptr(bias), _build.ptr(skip) if skip is not None else None,
        skip.stride(0) if skip is not None else 0, _build.ptr(out), heads, f, int(concat),
        int(elu), float(scale), _build.stream_handle(num.device))
    _build.check(rc, lib, "segment_attention")
    _launched("normalize")
    return out
