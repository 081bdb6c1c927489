"""GAT full-graph inference, plain PyTorch, written from the published
equations (Veličković et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903, §2.1 and the PPI model of §3.3), independent of the
program.

For a layer with input ``x`` of width D, H heads of width F, ``W ∈ [D,
H·F]`` (no bias in the projection) and attention vectors ``a_src, a_dst
∈ [H, F]``:

  z_v^h = x_v W^h
  s_v^h = <a_src^h, z_v^h>,  t_v^h = <a_dst^h, z_v^h>
  e_uv^h = LeakyReLU_0.2(t_v^h + s_u^h)              every edge u -> v, self loops included
  α_uv^h = exp(e_uv^h − max_u' e_u'v^h) / Σ_u' exp(e_u'v^h − max_u' e_u'v^h)
  y_v^h = Σ_u α_uv^h z_u^h                            0 for a vertex with no in-edge

Hidden layers: ``h_v = ELU(concat_h(y_v^h) + b [+ x_v W_skip])``; the
output layer: ``out_v = mean_h(y_v^h + b^h)``, no nonlinearity.
``W_skip ∈ [D, H·F]`` (no bias): the authors' residual across the
intermediate attentional layer (github.com/PetarV-/GAT, ``utils/layers.py``
``attn_head``, ``residual=True``: the input projected where its width
differs from a head's).

``precision``: ``"f64"`` (the reference), ``"f32"`` (TF32 off) or
``"tf32"`` (the control: the projections' inputs rounded to TF32, on CUDA
by the card's TF32 path, on the CPU by rounding to 10 mantissa bits,
nearest even).  The softmax subtracts the max.  Edge sums run in blocks of
``EDGE_BLOCK`` edges, sized for 1,024-wide f64 rows (4.3 GB a block's
gathered rows) beside the program's freed state.
"""

from __future__ import annotations

import contextlib

import torch

EDGE_BLOCK = 1 << 19  # edges gathered at once
DTYPES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}


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


def project(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in the precision's dtype (TF32 as the control asks)."""
    if precision == "tf32" and x.device.type != "cuda":
        x, w = _round_tf32(x), _round_tf32(w)
    with _matmul_precision(precision == "tf32" and x.device.type == "cuda"):
        return x @ w


def scores(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``[V, H]``: each head's ``<a^h, z_v^h>``, one matrix-vector product a
    head on the strided view (no copy of ``z``)."""
    heads, f = a.shape
    zh = z.view(z.shape[0], heads, f)
    return torch.stack([torch.mv(zh[:, h, :], a[h]) for h in range(heads)], 1)


def attention(z: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
              a_src: torch.Tensor, a_dst: torch.Tensor, slope: float) -> torch.Tensor:
    """``y [V, H, F]``: each vertex's softmax-weighted sum of its
    in-neighbours' ``z`` (``[V, H·F]``), head by head."""
    heads, f = a_src.shape
    zh = z.view(num_vertices, heads, f)
    s, t = scores(z, a_src), scores(z, a_dst)
    blocks = [(lo, min(lo + EDGE_BLOCK, src.numel())) for lo in range(0, src.numel(), EDGE_BLOCK)]

    def logits(lo, hi):
        return torch.nn.functional.leaky_relu(t[dst[lo:hi]] + s[src[lo:hi]], slope)

    m = torch.full((num_vertices, heads), -torch.inf, dtype=z.dtype, device=z.device)
    for lo, hi in blocks:
        m.scatter_reduce_(0, dst[lo:hi, None].expand(-1, heads), logits(lo, hi), "amax")
    den = torch.zeros((num_vertices, heads), dtype=z.dtype, device=z.device)
    y = torch.zeros_like(zh)
    for lo, hi in blocks:
        w = torch.exp(logits(lo, hi) - m[dst[lo:hi]])
        den.index_add_(0, dst[lo:hi], w)
        y.index_add_(0, dst[lo:hi], zh[src[lo:hi]] * w[:, :, None])
    del m
    live = den > 0
    y.div_(torch.where(live, den, torch.ones_like(den))[:, :, None])
    return y.mul_(live[:, :, None])


def forward(config: dict, src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
            x: torch.Tensor, layers, precision: str = "f64") -> torch.Tensor:
    """Every layer over the whole graph.  ``src``, ``dst``: int64 edge
    endpoints on ``x``'s device; ``layers``: per layer a dict of ``w``,
    ``a_src``, ``a_dst``, ``b`` and optionally ``w_skip``; ``config``
    gives ``concat`` per layer and ``negative_slope``.  Returns the last
    layer's ``[V, F]`` in the precision's dtype."""
    dtype = DTYPES[precision]
    slope = float(config["negative_slope"])
    h = x.to(dtype)
    for k, p in enumerate(layers):
        heads, f = p["a_src"].shape
        z = project(h, p["w"].to(dtype), precision)
        skip = project(h, p["w_skip"].to(dtype), precision) if "w_skip" in p else None
        del h
        y = attention(z, src, dst, num_vertices, p["a_src"].to(dtype), p["a_dst"].to(dtype),
                      slope)
        del z
        y.add_(p["b"].to(dtype).view(heads, f))
        if config["concat"][k]:
            h = y.view(num_vertices, heads * f)
            if skip is not None:
                h.add_(skip)
            del skip
            h = torch.nn.functional.elu(h, inplace=True)
        else:
            h = y.mean(1)
        del y
    return h
