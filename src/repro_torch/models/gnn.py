"""Message-passing GNN layer definitions + in-memory reference oracle.

The three models evaluated in the paper (§4.1): GraphConv/GCN [Kipf &
Welling], SAGEConv (mean) [Hamilton et al.] and GINConv [Xu et al.].
Each layer is described by a ``GNNLayerSpec`` that the broadcast engine,
the gather baselines, and the dense oracle all consume, so semantic
equivalence is checked against one single definition:

  GCN   m_{u->v} = h_u / sqrt(d_in(u) d_in(v))   (self-loops in topology)
        h'_v = act(W @ Σ m + b)
  SAGE  m_{u->v} = h_u / d_in(v)                 (mean over in-neighbors)
        h'_v = act(W @ [h_v ; Σ m] + b)          (self-concat)
  GIN   m_{u->v} = h_u
        h'_v = MLP((1+eps) h_v + Σ m)            (2-layer MLP)

and, port-only, GAT [Veličković et al., ICLR 2018], whose edge weights
are not the graph's but a softmax of scores made from the features (its
equations: ``models/gat_ref.py``).  A GAT layer projects before it
aggregates: its ``layer_update`` is the projection ``x @ [W | W_skip]``,
and its static edge weight is 1.  It runs on the device mesh
(``dist/mesh.py``); the out-of-core engine, which aggregates before it
transforms, refuses it (``require_static_weights``).

The broadcast engine realises the self term for SAGE/GIN as an extra
"self message" deposited when the vertex's own source chunk streams by
(required message count = d_in + 1), and for GCN via self-loops.

Port notes: parameters are made on the host with the same numpy RNG as
the JAX package (``init_gnn_params``), so a seed gives the same numbers;
``GNNLayerSpec.to`` moves them to a device once per layer, and
``layer_update`` runs the transform through kernel K2 there.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, degrees_from_csr
from repro_torch.kernels import ops, ref
from repro_torch.models import gat_ref


@dataclasses.dataclass(frozen=True)
class GNNLayerSpec:
    kind: str  # 'gcn' | 'sage' | 'gin' | 'gat'
    in_dim: int
    out_dim: int
    activation: bool  # ReLU after update (False on final layer); gat: ELU
    params: dict  # numpy arrays, or tensors on one device (``to``)
    # gat only: the heads and their concatenation (else their mean); the
    # head width is params["a_src"].shape[1]
    heads: int = 1
    concat: bool = True

    @property
    def hot_width(self) -> int:
        """Columns of partial state per vertex in the hot store.

        SAGE doubles the width (self ; neighbor-agg) — the paper calls out
        the resulting eviction pressure explicitly (§4.3).
        """
        return 2 * self.in_dim if self.kind == "sage" else self.in_dim

    @property
    def extra_self_message(self) -> bool:
        return self.kind in ("sage", "gin")

    def to(self, device) -> "GNNLayerSpec":
        """This spec with every parameter a float32 tensor on ``device``."""
        params = {
            k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device=device, dtype=torch.float32)
            .contiguous()
            for k, v in self.params.items()
        }
        return dataclasses.replace(self, params=params)


def specs_from_numpy(layers: Sequence[dict], device="cuda") -> list[GNNLayerSpec]:
    """Build the port's specs from plain layer descriptions — each a dict
    with ``kind``, ``in_dim``, ``out_dim``, ``activation`` and ``params``
    (numpy arrays) — with their weights on ``device``."""
    dev = resolve_device(device)
    return [
        GNNLayerSpec(
            kind=str(l["kind"]),
            in_dim=int(l["in_dim"]),
            out_dim=int(l["out_dim"]),
            activation=bool(l["activation"]),
            params=dict(l["params"]),
        ).to(dev)
        for l in layers
    ]


def init_gnn_params(
    kind: str, dims: Sequence[int], seed: int = 0, gin_eps: float = 0.0, *,
    heads: Sequence[int] | None = None, skip: Sequence[bool] | None = None,
    att_scale: Sequence[float] | None = None,
) -> list[GNNLayerSpec]:
    """Glorot-initialised stack of layers; dims = [in, hidden, ..., out].

    ``kind="gat"`` takes ``heads`` per layer (hidden layers concatenate
    theirs, ``dims[i+1] = heads·F``; the last averages, ``F = dims[-1]``),
    ``skip`` per layer (a ``W_skip [d_in, heads·F]``), and ``att_scale``
    per layer, a factor on the Glorot attention vectors ``[heads, F]``."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i], dims[i + 1]
        final = i == len(dims) - 2
        if kind == "gat":
            specs.append(_gat_layer(rng, d_in, d_out, final, heads[i],
                                    bool(skip[i]) if skip is not None else False,
                                    float(att_scale[i]) if att_scale is not None else 1.0))
            continue
        if kind == "gcn":
            w = _glorot(rng, (d_in, d_out))
            params = {"w": w, "b": np.zeros(d_out, np.float32)}
        elif kind == "sage":
            w = _glorot(rng, (2 * d_in, d_out))
            params = {"w": w, "b": np.zeros(d_out, np.float32)}
        elif kind == "gin":
            h = max(d_in, d_out)
            params = {
                "w1": _glorot(rng, (d_in, h)),
                "b1": np.zeros(h, np.float32),
                "w2": _glorot(rng, (h, d_out)),
                "b2": np.zeros(d_out, np.float32),
                "eps": np.float32(gin_eps),
            }
        else:
            raise ValueError(f"unknown GNN kind {kind!r}")
        specs.append(
            GNNLayerSpec(
                kind=kind,
                in_dim=d_in,
                out_dim=d_out,
                activation=not final,
                params=params,
            )
        )
    return specs


def _gat_layer(rng, d_in: int, d_out: int, final: bool, heads: int, skip: bool,
               att_scale: float) -> GNNLayerSpec:
    if heads < 1 or (not final and d_out % heads):
        raise ValueError(f"a concatenating GAT layer's width {d_out} must divide by its "
                         f"{heads} heads")
    f = d_out if final else d_out // heads
    params = {"w": _glorot(rng, (d_in, heads * f)),
              "a_src": _glorot(rng, (heads, f)) * np.float32(att_scale),
              "a_dst": _glorot(rng, (heads, f)) * np.float32(att_scale),
              "b": np.zeros(heads * f, np.float32)}
    if skip:
        if final:
            raise ValueError("the skip is a concatenating layer's")
        params["w_skip"] = _glorot(rng, (d_in, heads * f))
    return GNNLayerSpec(kind="gat", in_dim=d_in, out_dim=d_out, activation=not final,
                        params=params, heads=heads, concat=not final)


def _glorot(rng, shape) -> np.ndarray:
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


# --------------------------------------------------------------------------
# Edge weights (message normalisation, applied at construction time, §3.4)
# --------------------------------------------------------------------------


def edge_weights(
    kind: str, src: np.ndarray, dst: np.ndarray, in_deg: np.ndarray
) -> np.ndarray:
    """Per-edge scalar applied to the source embedding."""
    if kind == "gcn":
        d = np.maximum(in_deg, 1).astype(np.float64)
        return (1.0 / np.sqrt(d[src] * d[dst])).astype(np.float32)
    if kind == "sage":
        d = np.maximum(in_deg, 1).astype(np.float64)
        return (1.0 / d[dst]).astype(np.float32)
    if kind in ("gin", "gat"):  # gat: the attention is computed from the features
        return np.ones(len(src), dtype=np.float32)
    raise ValueError(kind)


def require_static_weights(spec: GNNLayerSpec) -> None:
    """Raise for a layer whose edge weights depend on the features (gat):
    the out-of-core engine sums messages before it transforms, with weights
    fixed by the graph, and its hot store holds no per-head denominators."""
    if spec.kind == "gat":
        raise ValueError("gat layers run on the device mesh (repro_torch.dist.mesh "
                         "run_layers); the out-of-core engine takes gcn, sage and gin")


def self_coefficient(spec: GNNLayerSpec) -> float:
    """Scale applied to a vertex's own embedding in its self message."""
    if spec.kind == "gin":
        return 1.0 + float(spec.params["eps"])
    return 1.0  # sage: raw copy into the self half


# --------------------------------------------------------------------------
# Layer update (the graduation transform — the accelerator step)
# --------------------------------------------------------------------------


def _update(spec: GNNLayerSpec, agg: torch.Tensor, graduate) -> torch.Tensor:
    act = "relu" if spec.activation else "none"
    p = spec.params
    if spec.kind in ("gcn", "sage"):
        return graduate(agg, p["w"], p["b"], act)
    if spec.kind == "gin":
        h = graduate(agg, p["w1"], p["b1"], "relu")
        return graduate(h, p["w2"], p["b2"], act)
    if spec.kind == "gat":  # the projection, [z | skip], before the aggregation
        w = torch.cat([p["w"], p["w_skip"]], 1) if "w_skip" in p else p["w"]
        return graduate(agg, w, torch.zeros_like(w[0]), "none")
    raise ValueError(spec.kind)


def layer_update(spec: GNNLayerSpec, agg: torch.Tensor) -> torch.Tensor:
    """Dense transform on finalized aggregate rows ``[n, hot_width]``, on
    ``agg``'s device (K2 on CUDA): one fused call for gcn/sage, two for
    gin's MLP; for gat the projection of its input rows, ``x @ [W |
    W_skip]``.  ``spec``'s parameters must already live there."""
    return _update(spec, agg, ops.graduate)


# --------------------------------------------------------------------------
# Dense in-memory reference (the oracle, paper §4.1's "reference")
# --------------------------------------------------------------------------


def dense_reference(
    csr: CSRGraph, features: np.ndarray, specs: list[GNNLayerSpec], device="cuda"
) -> np.ndarray:
    """Full-graph layer-wise inference, everything in memory on
    ``device``, through the plain versions of the kernels (never the
    kernels themselves), so it stays an independent oracle on the card.
    Returns the final embeddings as a numpy ``[V, out_dim]`` array."""
    dev = resolve_device(device)
    if any(spec.kind == "gat" for spec in specs):
        if not all(spec.kind == "gat" for spec in specs):
            raise ValueError("a stack mixes gat with other kinds")
        return gat_ref.forward(csr, features, specs, torch.float32, dev).cpu().numpy()
    in_deg, _ = degrees_from_csr(csr)
    src, dst = csr.edges_for_range(0, csr.num_vertices)
    src_t = torch.from_numpy(np.asarray(src, np.int64)).to(dev)
    dst_t = torch.from_numpy(np.asarray(dst, np.int64)).to(dev)
    h = torch.from_numpy(np.asarray(features, np.float32)).to(dev)
    for spec in specs:
        spec = spec.to(dev)
        w = torch.from_numpy(edge_weights(spec.kind, src, dst, in_deg)).to(dev)
        agg = ref.edge_block_spmm_ref(h, src_t, dst_t, w, csr.num_vertices)
        if spec.kind == "sage":
            agg = torch.cat([h * self_coefficient(spec), agg], dim=1)
        elif spec.kind == "gin":
            agg = agg + h * self_coefficient(spec)
        h = _update(spec, agg, ref.fused_graduate_ref)
    return h.cpu().numpy()
