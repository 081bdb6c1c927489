"""GAT full-graph inference in plain PyTorch: the port's oracle for
``kind="gat"`` (Veličković et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903).

For a layer with input ``x`` of width D, H heads of width F, weights
``W ∈ [D, H·F]`` (no bias in the projection) and attention vectors
``a_src, a_dst ∈ [H, F]``:

  z_v^h = x_v W^h
  s_v^h = <a_src^h, z_v^h>,  t_v^h = <a_dst^h, z_v^h>
  e_uv^h = LeakyReLU_0.2(t_v^h + s_u^h)            every edge u -> v, self loops included
  α_uv^h = exp(e_uv^h − max_u' e_u'v^h) / Σ_u' exp(e_u'v^h − max_u' e_u'v^h)
  y_v^h = Σ_u α_uv^h z_u^h                          0 for a vertex with no in-edge

Hidden layers: ``h_v = ELU(concat_h(y_v^h) + b [+ x_v W_skip])``; the
output layer: ``out_v = mean_h(y_v^h + b^h)``, no nonlinearity.
``W_skip ∈ [D, H·F]`` (no bias) is the authors' residual across an
attentional layer whose input width differs from its heads' (their
``utils/layers.py`` ``attn_head``, ``residual=True``).

A layer is anything with ``params`` (``w``, ``a_src``, ``a_dst``, ``b``,
optionally ``w_skip``), ``concat`` and ``activation``: the port's
``GNNLayerSpec``.  Everything runs in the dtype asked for (f32 or f64)
with TF32 off, the softmax with its max subtracted.  Imports no kernel of
the port.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(device, dtype)


def attention(z: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
              a_src: torch.Tensor, a_dst: torch.Tensor) -> torch.Tensor:
    """``y [V, H, F]``: each vertex's softmax-weighted sum of its
    in-neighbours' ``z`` (``[V, H·F]``), head by head."""
    heads, f = a_src.shape
    zh = z.reshape(num_vertices, heads, f)
    s = (zh * a_src).sum(-1)
    t = (zh * a_dst).sum(-1)
    e = F.leaky_relu(t[dst] + s[src], 0.2)  # [E, H]
    m = torch.full((num_vertices, heads), -torch.inf, dtype=z.dtype, device=z.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, heads), e, "amax", include_self=True)
    w = torch.exp(e - m[dst])
    den = torch.zeros((num_vertices, heads), dtype=z.dtype, device=z.device).index_add_(0, dst, w)
    num = torch.zeros_like(zh).index_add_(0, dst, zh[src] * w[:, :, None])
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return torch.where((den > 0)[:, :, None], num / safe[:, :, None], torch.zeros_like(num))


def layer(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
          spec) -> torch.Tensor:
    """One GAT layer over the whole graph, in ``x``'s dtype."""
    p, dtype, dev = spec.params, x.dtype, x.device
    a_src, a_dst = _t(p["a_src"], dtype, dev), _t(p["a_dst"], dtype, dev)
    heads, f = a_src.shape
    with _no_tf32():
        z = x @ _t(p["w"], dtype, dev)
        skip = x @ _t(p["w_skip"], dtype, dev) if "w_skip" in p else None
    y = attention(z, src, dst, num_vertices, a_src, a_dst)
    y = y + _t(p["b"], dtype, dev).reshape(heads, f)
    if not spec.concat:
        return y.mean(1)
    h = y.reshape(num_vertices, heads * f)
    if skip is not None:
        h = h + skip
    return F.elu(h) if spec.activation else h


def forward(csr, features, specs, dtype: torch.dtype = torch.float64,
            device="cpu") -> torch.Tensor:
    """Every layer of ``specs`` over the graph ``csr`` (``edges_for_range``)
    from ``features`` ``[V, D]``: the last layer's output in ``dtype``."""
    v = csr.num_vertices
    src, dst = csr.edges_for_range(0, v)
    src = torch.from_numpy(np.asarray(src, np.int64)).to(device)
    dst = torch.from_numpy(np.asarray(dst, np.int64)).to(device)
    h = _t(features, dtype, device)
    for spec in specs:
        h = layer(h, src, dst, v, spec)
    return h
