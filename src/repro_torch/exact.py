"""Exact-arithmetic harness: graphs/features/weights whose every fp32
sum is exactly representable, so accumulation *order* cannot change the
result.

In-degrees are powers of two (each normalisation 1/d is a power of two),
features and weights are small integers — every partial sum along a
2-to-3-layer GCN/SAGE pipeline stays well inside fp32's 24-bit mantissa.
Any two schedules of the same computation — pairwise vs sequential
reduction, single-machine vs N-shard with cross-shard message routing —
must then agree **bitwise**; a namespace or routing bug shows up as
inequality instead of hiding inside a float tolerance.  This is the
identity oracle behind the reordering tests, the distributed
shard-sweep tests, and the CI dist smoke leg.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph, build_csr, degrees_from_csr
from repro_torch.models.gnn import GNNLayerSpec


def pow_degree_graph(
    v: int,
    degree_choices,
    seed: int,
    self_loops: bool,
    src_range: int | None = None,
) -> CSRGraph:
    """Every vertex's in-degree is exactly a power of two drawn from
    ``degree_choices`` (self-loop included when ``self_loops``), with
    distinct ring-offset sources.  ``src_range`` restricts sources to
    ``[0, src_range)`` so vertices above it have zero out-degree (the
    reduceat empty-segment case)."""
    rng = np.random.default_rng(seed)
    t = rng.choice(np.asarray(degree_choices), size=v)
    n_ext = t - 1 if self_loops else t
    mod = v if src_range is None else src_range
    assert n_ext.max() < mod
    dst = np.repeat(np.arange(v), n_ext)
    offsets = np.concatenate([np.arange(1, n + 1) for n in n_ext])
    src = (dst + offsets) % mod
    if self_loops:
        loop = np.arange(v)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    csr = build_csr(src, dst, v)
    in_deg, _ = degrees_from_csr(csr)
    assert np.array_equal(np.sort(np.unique(in_deg)), np.sort(np.unique(t)))
    return csr


def int_features(v: int, d: int, seed: int) -> np.ndarray:
    """Small-integer fp32 features in [-2, 2]."""
    return np.random.default_rng(seed).integers(-2, 3, size=(v, d)).astype(
        np.float32
    )


def int_specs(kind: str, dims, seed: int) -> list[GNNLayerSpec]:
    """Layer stack with small-integer weights/bias: together with
    power-of-two edge weights, every sum along the pipeline stays well
    inside fp32's 24-bit mantissa, so results are order-exact."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i], dims[i + 1]
        w_rows = 2 * d_in if kind == "sage" else d_in
        specs.append(GNNLayerSpec(
            kind=kind, in_dim=d_in, out_dim=d_out,
            activation=i < len(dims) - 2,
            params={
                "w": rng.integers(-1, 2, size=(w_rows, d_out)).astype(np.float32),
                "b": rng.integers(-2, 3, size=d_out).astype(np.float32),
            },
        ))
    return specs


def exact_graph_and_specs(
    v: int,
    d: int,
    kind: str = "gcn",
    seed: int = 7,
    degree_choices=(4, 16),
    dims=None,
):
    """One-call fixture: ``(csr, features, specs)`` for an exact-arithmetic
    ``kind`` run (self-loops included — GCN requires them).  Degrees are
    powers of FOUR: GCN's symmetric normalisation takes
    ``1/sqrt(d_src*d_dst)``, which is a power of two (exact) only when
    the degree product is a power of four."""
    csr = pow_degree_graph(v, degree_choices, seed=seed, self_loops=True)
    feats = int_features(v, d, seed=seed + 1)
    specs = int_specs(kind, dims or [d, 2 * d, d // 2 or 1], seed=seed + 2)
    return csr, feats, specs


__all__ = [
    "exact_graph_and_specs",
    "int_features",
    "int_specs",
    "pow_degree_graph",
]
