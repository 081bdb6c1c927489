"""Seeded synthetic graph generators.

The paper evaluates on OGBN-Papers100M / MAG240M-Cites / IGB-Large /
IGB-Full (Table 1).  Those are 54-550 GiB feature sets; here we generate
*scaled-down* graphs with the same structural character (heavy-tailed
in-degree, ~12-16 avg degree) so every experiment shape — read
amplification, eviction churn, ordering span — reproduces at laptop scale.
Configs in ``repro_torch.configs.atlas_gnn`` pin (V, E, d, dtype) per dataset
analog.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph, build_csr


def powerlaw_graph(
    num_vertices: int,
    avg_degree: float,
    seed: int = 0,
    exponent: float = 1.05,
    self_loops: bool = True,
) -> CSRGraph:
    """Directed graph with heavy-tailed *in*-degree (preferential-attachment
    flavoured, but O(E) vectorised: destinations drawn from a Zipf-like
    distribution over vertex ids, sources uniform).

    Citation graphs (Papers/MAG/IGB) have heavy-tailed in-degree (highly
    cited papers) and bounded out-degree (reference lists) — this generator
    mirrors that: hub destinations stress the hot store exactly the way the
    paper's eviction ablation (Fig 7) needs.
    """
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    # Zipf-ish weights over a permuted id space so hubs are spread across
    # the id range (matching real relabelled datasets, not sorted by rank).
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    weights = ranks ** (-exponent)
    weights /= weights.sum()
    perm = rng.permutation(num_vertices)
    dst = perm[rng.choice(num_vertices, size=num_edges, p=weights)]
    src = rng.integers(0, num_vertices, size=num_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if self_loops:
        loop = np.arange(num_vertices, dtype=src.dtype)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    return build_csr(src, dst, num_vertices)


def uniform_graph(
    num_vertices: int,
    avg_degree: float,
    seed: int = 0,
    self_loops: bool = True,
) -> CSRGraph:
    """Erdos-Renyi-style directed graph (uniform endpoints)."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    src = rng.integers(0, num_vertices, size=num_edges)
    dst = rng.integers(0, num_vertices, size=num_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if self_loops:
        loop = np.arange(num_vertices, dtype=src.dtype)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    return build_csr(src, dst, num_vertices)


def rmat_graph(
    num_vertices: int,
    avg_degree: float,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    self_loops: bool = True,
    shuffle_ids: bool = True,
) -> CSRGraph:
    """R-MAT / Kronecker recursive-matrix graph (Chakrabarti et al.;
    Graph500 uses a=0.57, b=c=0.19, d=0.05 — the defaults here).

    Each edge descends ``ceil(log2 V)`` levels of a recursively
    partitioned adjacency matrix, choosing a quadrant per level with
    probabilities (a, b, c, d): self-similar communities at every scale
    plus a heavy-tailed degree distribution — the structural character
    the fig6/fig8 sweeps need beyond the flat-block ``community_graph``
    (real community locality is hierarchical, so ordering headroom and
    eviction churn are graded, not binary).  Ids are shuffled by default,
    like ``community_graph`` — structure-correlated ids would hand the
    reordering experiments their answer for free."""
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError(f"quadrant probabilities sum to {a + b + c} > 1")
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    levels = max(1, int(np.ceil(np.log2(max(num_vertices, 2)))))
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(levels):
        r = rng.random(num_edges)
        # quadrant draw: [0,a) -> TL, [a,a+b) -> TR, [a+b,a+b+c) -> BL,
        # rest -> BR.  src bit set in the Bottom half, dst bit in the
        # Right half.
        src_bit = r >= a + b
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + src_bit
        dst = dst * 2 + dst_bit
    keep = (src < num_vertices) & (dst < num_vertices) & (src != dst)
    src, dst = src[keep], dst[keep]
    if shuffle_ids:
        perm = rng.permutation(num_vertices)
        src, dst = perm[src], perm[dst]
    if self_loops:
        loop = np.arange(num_vertices, dtype=src.dtype)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    return build_csr(src, dst, num_vertices)


def make_features(
    num_vertices: int,
    feat_dim: int,
    dtype=np.float32,
    seed: int = 0,
) -> np.ndarray:
    """Seeded dense features, standard-normal scaled by 1/sqrt(d)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_vertices, feat_dim)) / np.sqrt(feat_dim)
    return feats.astype(dtype)


def make_features_mmap(
    num_vertices: int,
    feat_dim: int,
    path: str,
    dtype=np.float32,
    seed: int = 0,
    chunk_rows: int = 262_144,
) -> np.ndarray:
    """``make_features`` for graphs whose feature matrix should not live
    in RAM: generate chunk by chunk straight into an on-disk ``.npy``
    and return a read-only memmap view.  Identical values to
    ``make_features`` for the same (num_vertices, feat_dim, seed) — the
    generator stream is chunk-size-invariant because each chunk draws
    exactly ``chunk_rows * feat_dim`` normals in row order.  This is how
    the multi-M-vertex benchmarks feed ``GraphStore.create`` (which
    itself streams row slices) without materialising V×d floats."""
    rng = np.random.default_rng(seed)
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=np.dtype(dtype), shape=(num_vertices, feat_dim)
    )
    for s in range(0, num_vertices, max(1, chunk_rows)):
        e = min(s + chunk_rows, num_vertices)
        # same draw order and same ops as make_features, so the values
        # are bit-identical to the in-RAM generator at any chunk size
        out[s:e] = (
            rng.standard_normal((e - s, feat_dim)) / np.sqrt(feat_dim)
        ).astype(dtype)
    out.flush()
    del out
    return np.load(path, mmap_mode="r")


def community_graph(
    num_vertices: int,
    avg_degree: float,
    num_communities: int = 64,
    intra_frac: float = 0.9,
    seed: int = 0,
    self_loops: bool = True,
    shuffle_ids: bool = True,
) -> CSRGraph:
    """Stochastic-block-style directed graph: `intra_frac` of edges stay
    within a community, the rest cross.  Vertex ids are shuffled (real
    datasets arrive with ids uncorrelated to structure) — this is the
    workload where graph *reordering* (paper §3.8 / Fig 6) has headroom:
    a good order processes communities coherently, so destination partial
    states complete quickly instead of staying open across the whole pass.
    """
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    comm_of = np.sort(rng.integers(0, num_communities, size=num_vertices))
    # contiguous community blocks in the *structural* id space
    src_s = rng.integers(0, num_vertices, size=num_edges)
    intra = rng.random(num_edges) < intra_frac
    # intra edges: destination within the source's community block
    starts = np.searchsorted(comm_of, np.arange(num_communities))
    ends = np.searchsorted(comm_of, np.arange(num_communities), side="right")
    c = comm_of[src_s]
    lo, hi = starts[c], np.maximum(ends[c], starts[c] + 1)
    dst_intra = lo + (rng.random(num_edges) * (hi - lo)).astype(np.int64)
    dst_inter = rng.integers(0, num_vertices, size=num_edges)
    dst_s = np.where(intra, dst_intra, dst_inter)
    if shuffle_ids:
        perm = rng.permutation(num_vertices)
        src, dst = perm[src_s], perm[dst_s]
    else:
        src, dst = src_s, dst_s
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if self_loops:
        loop = np.arange(num_vertices, dtype=src.dtype)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
    return build_csr(src, dst, num_vertices)
