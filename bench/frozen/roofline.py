"""Kernels' operations and bytes, and the H100's published peaks, frozen.

``H100``, ``band_pairs``, ``kernel_cost`` and ``bound_ms`` are copied from
``src/repro_torch/perf/hlo_cost.py`` at commit
4cdb0a73912ceae5e46a51aa52d89d73ba4acce5.  Peaks: NVIDIA's data sheet for
the H100 SXM, dense rates (989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 outside them, 3.35 TB/s HBM3).  ``tensors`` are ``(shape,
dtype name)`` pairs, inputs then outputs; each byte is counted once.
"""

from __future__ import annotations

import math

import torch

H100 = {
    "peak_flops": 989e12,  # bf16 tensor cores, dense, H100 SXM (published)
    "peak_flops_f32": 67e12,  # f32 without tensor cores
    "hbm_bw": 3.35e12,  # B/s HBM3
    "ici_bw": 450e9,  # B/s each way, NVLink 4
}


def _nbytes(spec) -> int:
    shape, dtype = spec
    return math.prod(shape) * getattr(torch, dtype).itemsize


def band_pairs(s: int, window: int | None, causal: bool = True) -> int:
    """(query, key) pairs a query of ``s`` rows sees: the causal triangle,
    cut to the band ``q - k < window``."""
    if not causal:  # every key after the query's band start
        w = s if window is None else min(window, s)
        return s * s - (s - w) * (s - w + 1) // 2
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def kernel_cost(name: str, tensors, **attrs) -> dict:
    """FLOPs, bytes and transcendentals of one kernel call, and the peak
    rate its FLOPs run at on an H100: the formulas of ``PERF.md``'s bound
    column.  ``tensors`` are ``(shape, dtype name)`` pairs, inputs then
    outputs, as the wrapper notes them (``kernels/_build.note``); the
    bytes read each input once and write each output once."""
    tensors = [(tuple(s), d) for s, d in tensors]
    nbytes = sum(_nbytes(t) for t in tensors)
    (shape0, dtype0) = tensors[0]
    peak = H100["peak_flops"] if dtype0 == "bfloat16" else H100["peak_flops_f32"]
    trans = 0
    if name in ("flash_attention", "flash_attention_bwd"):
        b, hq, s, d = shape0
        pairs = band_pairs(s, attrs.get("window"), attrs.get("causal", True))
        # forward: QKᵀ and PV inside the band; backward: S recomputed, dP, dV, dQ, dK
        flops = (4 if name == "flash_attention" else 10) * b * hq * d * pairs
        trans = b * hq * pairs
    elif name in ("ssd_scan", "ssd_scan_bwd"):
        bh, s, p = shape0
        n = tensors[2][0][-1]
        chunk = attrs["chunk"]
        tri = chunk * (chunk + 1) // 2
        if name == "ssd_scan":
            flops = bh * (s // chunk) * (2 * tri * (n + p) + 4 * chunk * p * n)
        else:
            # five products on and below the diagonal (C Bᵀ, dY Xᵀ, dX, dB, dC),
            # three with the state (B dSᵀ, X dS, dY S_in), the two recurrences
            flops = bh * (s // chunk) * (2 * tri * (3 * n + 2 * p) + 2 * 5 * chunk * p * n)
        trans = bh * (s // chunk) * tri
    elif name in ("rms_norm", "rms_norm_bwd"):
        rows, d = shape0
        flops = (4 if name == "rms_norm" else 14) * rows * d  # ~14 f32 ops an element back
        trans = rows
        peak = H100["peak_flops_f32"]
    elif name in ("rglru_scan", "rglru_scan_bwd"):
        b, s, r = shape0
        flops = (2 if name == "rglru_scan" else 4) * b * s * r
        peak = H100["peak_flops_f32"]
    elif name == "fused_graduate":
        (n, k), m = shape0, tensors[1][0][1]
        flops = 2 * n * k * m
        trans = n * m if attrs.get("activation") == "gelu" else 0
    elif name == "edge_block_spmm":
        d = shape0[1]
        flops = 2 * tensors[1][0][0] * d  # two per edge and feature
        peak = H100["peak_flops_f32"]
    else:
        raise ValueError(f"unknown kernel {name!r}")
    return {"flops": flops, "bytes": nbytes, "transcendentals": trans, "peak_flops": peak}


def bound_ms(cost: dict, hw: dict = H100) -> tuple[float, str]:
    """The least time the card could take for ``kernel_cost``'s work: its
    bytes over HBM or its FLOPs at their peak, whichever is longer, and
    which (``"bytes"`` or ``"operations"``)."""
    t_bytes = cost["bytes"] / hw["hbm_bw"] * 1e3
    t_ops = cost["flops"] / cost["peak_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
