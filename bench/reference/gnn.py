"""GCN and GraphSAGE (mean) full-graph inference, plain PyTorch.

Written from the published layer equations, independent of the program:

  GCN  (Kipf & Welling, ICLR 2017):
       h'_v = act(W^T sum_{u -> v} h_u / sqrt(deg(u) deg(v)) + b)
  SAGE (Hamilton et al., NeurIPS 2017, mean aggregator):
       h'_v = act(W^T [h_v ; mean_{u -> v} h_u] + b)

``deg`` is the in-degree; the graph carries a self loop at every vertex,
so the GCN sum and the SAGE mean include the vertex itself.  ``act`` is
relu between layers and the identity after the last.  The weight of a
SAGE layer stacks the self rows over the neighbour rows, ``[2·d_in,
d_out]``.

``precision``: ``"f64"`` (the reference), ``"f32"`` (TF32 off) or
``"tf32"`` (the control: float32 with the products' inputs rounded to
TF32; on CUDA by the card's own TF32 path, on the CPU by rounding them to
10 mantissa bits, nearest even).  Edge sums run in blocks of edges so
that a graph of some tens of millions of edges fits beside the program's
freed state.
"""

from __future__ import annotations

import contextlib

import torch

EDGE_BLOCK = 1 << 21  # edges gathered at once


def edge_weights(kind: str, src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The message scale of each edge, worked out from the graph."""
    deg = torch.bincount(dst, minlength=num_vertices).clamp_min(1).to(torch.float64)
    if kind == "gcn":
        w = 1.0 / torch.sqrt(deg[src] * deg[dst])
    elif kind == "sage":
        w = 1.0 / deg[dst]
    else:
        raise ValueError(f"the reference runs gcn and sage, not {kind!r}")
    return w.to(dtype)


def aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """``out[v] = sum over edges u -> v of w·h[u]``, in ``h``'s dtype."""
    out = torch.zeros_like(h)
    for lo in range(0, src.numel(), EDGE_BLOCK):
        hi = min(lo + EDGE_BLOCK, src.numel())
        out.index_add_(0, dst[lo:hi], h[src[lo:hi]] * w[lo:hi, None])
    return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _linear(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32" and z.device.type != "cuda":
        z, w = _round_tf32(z), _round_tf32(w)
    with _matmul_precision(precision == "tf32" and z.device.type == "cuda"):
        return z @ w + b


DTYPES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}


def forward(kind: str, src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
            x: torch.Tensor, layers, precision: str = "f64") -> torch.Tensor:
    """Every layer over the whole graph.  ``src``, ``dst``: int64 edge
    endpoints on ``x``'s device; ``layers``: ``(w, b)`` per layer.
    Returns the last layer's ``[V, d_out]`` in the precision's dtype."""
    dtype = DTYPES[precision]
    w_edge = edge_weights(kind, src, dst, num_vertices, dtype)
    h = x.to(dtype)
    for k, (w, b) in enumerate(layers):
        agg = aggregate(h, src, dst, w_edge)
        z = torch.cat([h, agg], dim=1) if kind == "sage" else agg
        del agg
        h = _linear(z, w.to(dtype), b.to(dtype), precision)
        del z
        if k < len(layers) - 1:
            h = torch.relu(h)
    return h


def row_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of a row, over rows: ``max |out - ref|`` of the row
    over the larger of the row's ``max |ref|`` and the median row's.
    ``inf`` where ``out`` is not finite or not of ``ref``'s shape."""
    if out.shape != ref.shape:
        return float("inf")
    out = out.to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    if not bool(torch.isfinite(out).all()):
        return float("inf")
    gap = (out - ref).abs().amax(dim=1)
    scale = ref.abs().amax(dim=1)
    floor = scale.median()
    return float((gap / torch.maximum(scale, floor)).max())
