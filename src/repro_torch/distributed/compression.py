"""Int8 gradient compression with error feedback, ported from
``repro/distributed/compression.py``.

At 1000+ nodes the DP gradient all-reduce is the dominant cross-pod
collective; int8 quantization cuts its wire bytes 4x (vs f32) / 2x (vs
bf16).  Naive quantization biases training; *error feedback* (Seide et
al.; 1-bit SGD lineage) keeps the local quantization residual and adds it
back before the next round, which makes the scheme unbiased in the long
run.

``compressed_psum`` takes the per-position tensors of one mesh axis (a
list, one per position, each on its position's device): the pmax of the
per-tensor absmax scales, each position's codes against that shared
scale, their int32 sum, dequantized.  ``compressed_psum_group`` is the
same over a ``torch.distributed`` process group (gloo on the CPU).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes,
scales and sums are the reference's bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clip(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """(grad, error_buffer) -> (q, scale, new_error_buffer)."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def _codes(corrected: torch.Tensor, shared: torch.Tensor):
    """The int32 codes against the shared scale, and the residual
    ``corrected - q·shared`` rounded once to f32 (computed in f64, where
    it is exact: the reference's jitted form fuses it into one FMA)."""
    q = torch.clip(torch.round(corrected / shared), -127, 127).to(torch.int32)
    residual = corrected.double() - q.double() * shared.double()
    return q, residual.to(torch.float32)


def compressed_psum(grads: list, errs: list) -> tuple[list, list]:
    """Error-feedback int8 sum over the positions of one mesh axis.

    ``grads`` and ``errs`` hold one tensor per position.  Returns (each
    position's f32 sum, each position's new error buffer).  Wire bytes: 1
    B per element of int8 payload (vs 4 B in f32) and one f32 scale per
    tensor.  Quantizing against the *shared* (pmax) scale puts the whole
    lossy path in the error buffer: the sum of the codes is exact, and over
    T rounds the mean dequantized sum converges to the true sum at O(1/T).
    """
    corrected = [g.to(torch.float32) + e for g, e in zip(grads, errs)]
    scales = [torch.clamp(c.abs().max() / 127.0, min=1e-12) for c in corrected]
    shared = [torch.stack([s.to(c.device) for s in scales]).max() for c in corrected]
    codes = [_codes(c, s) for c, s in zip(corrected, shared)]
    total = [sum(q.to(c.device) for q, _ in codes) for c in corrected]
    return ([t.to(torch.float32) * s for t, s in zip(total, shared)],
            [new for _, new in codes])


def compressed_psum_group(g: torch.Tensor, err: torch.Tensor, group=None):
    """``compressed_psum`` for this rank's tensor over a process group:
    an all-reduce MAX of the scale, then an all-reduce SUM of the int32
    codes.  Returns (the f32 sum, this rank's new error buffer)."""
    corrected = g.to(torch.float32) + err
    shared = torch.clamp(corrected.abs().max() / 127.0, min=1e-12)
    dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
    q, new_err = _codes(corrected, shared)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(torch.float32) * shared, new_err


def init_error_buffers(grads):
    """Zero f32 error buffers shaped like a tree of gradients."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
