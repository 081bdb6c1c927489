"""The port's CUDA kernels and its engine on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  Run them on a GPU machine with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; the CPU tests hold the plain versions against JAX.

Tolerances: K1 rtol=1e-4/atol=1e-5 against its plain version (another
summation order), bitwise against itself and its "rows" route bitwise
against its "general" route (one summation order in both), and both
bitwise a numpy emulation of that order (slabs of ``slab_edges()`` edges,
each summed from 0 in edge order, added in slab order); K2 1e-5 in f32 and 2e-2 in
bf16; the engine, its sharded runs (thread, mesh and process workers)
and the gather baselines bitwise against their CPU or single-machine
runs on exact-arithmetic graphs; the mesh steps bitwise against the
dense reference on exact graphs.
K3 2e-5 in f32 and 5e-2 in bf16 (tests/test_kernels.py's bars; online
versus one-pass softmax order), K4 2e-4 in f32 and 2e-2 in bf16 (the
chunked form's exponentials and cumsum in another order; the tensor-core
route's f32 operands enter as bf16 hi + lo pairs) and its final state
2e-4 in both
dtypes, K5 1e-5 in f32
and 2e-2 in bf16 — each against its plain version on the same card, and
each bitwise against itself.  K3 with a window and at head dim 256
(recurrentgemma's local attention) at the same bars, forward and backward,
on the route its rule picks (bf16 on the tensor cores, f32 and unaligned
views on the CUDA cores).  K6 (the RG-LRU scan) and its backward bitwise
against their plain versions.  The backward kernels of K3 and K5 against
their plain backward versions at 1e-5 in f32 and 2e-2 in bf16 on both
routes (K3's tensor-core route rounds P and dS to bf16 before their
products), and bitwise against themselves; K5's dscale, a sum over the rows of terms of
either sign taken in another order, relative to its largest magnitude; the train step on the card
against the same steps on the CPU at 1e-5 (losses) and resumed from a
checkpoint bitwise.  K4's backward against its plain backward within
2e-4 (f32) and 2e-2 (bf16) of each gradient's largest magnitude (db and dc
sum the heads of a row, da is a reverse cumsum of terms of either sign),
and bitwise against itself; the MoE layer's forward and gradients bitwise
across two runs on the card and within 1e-4 of the CPU run in f32.  The
MoE layer split over two model positions: its routing bitwise one
device's, its output and gradients within 2e-2 in bf16 and 1e-5 in f32;
the split moe train and serving steps within 1e-4 of one device (f32
smoke configs, the routing the same on both).
"""

import numpy as np
import pytest
import torch

from repro_torch import exact
from repro_torch.core import gather_ref
from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.dist import DistSession
from repro_torch.dist import mesh as dist_mesh
from repro_torch.kernels import edge_block_spmm as ebs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_graduate as fg
from repro_torch.kernels import rglru_scan as k6
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    rglru_scan_bwd_ref,
    rglru_scan_ref,
    rms_norm_bwd_ref,
    rms_norm_ref,
    segment_reduce_sorted_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.configs import list_archs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import dense_reference, init_gnn_params, layer_update
from repro_torch.session import AtlasSession
from repro_torch.storage.layout import GraphStore

pytestmark = pytest.mark.gpu

SPMM_GRID = [
    (64, 16, 300, 500),  # typical
    (100, 32, 0, 500),  # empty chunk (E=0)
    (5, 8, 1, 9),  # single edge
    (33, 130, 257, 77),  # nothing a multiple of any block
    (1, 1, 1, 1),  # degenerate minimum
    (300, 24, 2000, 40),  # heavy fan-in (many edges per dst)
]
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
K3_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
K4_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
K5_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (b, hq, hkv, s, d): MHA, GQA, MQA; ragged S; small and odd head dims.
# bf16 at d = 64 and 128 takes the tensor-core route (fa.route): qwen3's
# served wave (Hq=40, Hkv=8, S=125, group 5), S not a multiple of 64, S=1
ATTN_GRID = [
    (2, 4, 4, 256, 64),
    (1, 8, 2, 200, 128),
    (2, 8, 1, 77, 16),
    (1, 4, 2, 1, 128),
    (1, 2, 1, 130, 100),
    (1, 40, 8, 125, 128),
    (2, 10, 2, 125, 64),
    (1, 5, 1, 1, 64),
    (1, 8, 8, 300, 128),
]
# (n, k, m) of the graduation transform: ragged odd shapes (the CUDA-core
# route in both dtypes), the GNN path's widths, and shapes the bf16
# tensor-core route takes (k % 8 == 0, m % 8 == 0): one row, a tile edge
K2_GRID = [
    (300, 130, 70),
    (64, 512, 172),
    (1, 7, 3),
    (300, 256, 256),
    (8192, 512, 256),
    (1, 512, 256),
    (129, 64, 136),
]
# (bh, s, p, n, chunk, heads_per_bc): the Pallas grid, mamba's shape with
# shared b/c, a chunk that is not a multiple of the 64-row tiles, the
# smoke config's chunk
SSD_GRID = [
    (3, 128, 16, 32, 32, 1),
    (4, 512, 64, 128, 256, 2),
    (2, 200, 8, 16, 100, 1),
    (6, 48, 8, 16, 16, 3),
]
# (n, d): warp rows, block rows, a row length with no 16-byte vectors
RMS_GRID = [(64, 128), (257, 512), (3, 5120), (7, 2560), (5, 100), (1, 1)]
# (bh, s, n, chunk, heads_per_bc) on K4's tensor-core route (bf16, P = 64):
# three chunks of 256 (the state pass carries twice), chunks of 64, N = 64,
# and mamba2-2.7b's served wave (10.5 M outputs: the tail of the error)
SSD_TC_GRID = [
    (6, 768, 128, 256, 3),
    (320, 512, 128, 256, 80),
    (4, 256, 128, 64, 2),
    (4, 192, 64, 64, 4),
    # mamba2-2.7b's 80 heads over two model positions: 40 a B/C row
    (160, 1024, 128, 256, 40),
    (80, 512, 128, 256, 40),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _spmm_inputs(n, d, m, num_dst, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, num_dst, m).astype(np.int32)
    w = rng.uniform(-1, 1, m).astype(np.float32)
    return feats, src, dst, w


def _sorted(feats, src, dst, w, device):
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=int(dst.max(initial=-1)) + 1)
    offsets = np.r_[0, np.cumsum(counts)].astype(np.int32)
    return [
        torch.from_numpy(a).to(device)
        for a in (feats, src[order].astype(np.int32), w[order], offsets)
    ]


@pytest.mark.parametrize("n,d,m,num_dst", SPMM_GRID)
def test_k1_kernel_matches_plain(cuda, n, d, m, num_dst):
    feats, src, dst, w = _spmm_inputs(n, d, m, num_dst, seed=m + d)
    ops = _sorted(feats, src, dst, w, cuda)
    before = ebs.launches.value
    got = ebs.segment_reduce_sorted(*ops)
    again = ebs.segment_reduce_sorted(*ops)
    torch.cuda.synchronize()
    assert ebs.launches.value == before + (2 if m else 0)
    torch.testing.assert_close(got, segment_reduce_sorted_ref(*ops), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, again)
    host = [torch.from_numpy(a) for a in (feats, src, dst, w)]
    full = ebs.edge_block_spmm(*(t.to(cuda) for t in host), num_dst)
    torch.testing.assert_close(
        full.cpu(), ebs.edge_block_spmm(*host, num_dst), rtol=1e-4, atol=1e-5
    )


def test_k1_bf16_and_sentinels(cuda):
    feats, src, dst, w = _spmm_inputs(200, 36, 3000, 90, seed=3)
    src[::11] = -1
    ops = _sorted(feats, src, dst, w, cuda)
    ops[0] = ops[0].to(torch.bfloat16)
    torch.testing.assert_close(
        ebs.segment_reduce_sorted(*ops), segment_reduce_sorted_ref(*ops),
        rtol=1e-4, atol=1e-5,
    )


def _k1_general(feats, src, w, offsets):
    """K1's general kernel through its C entry, at any shape: the route
    every call took before the "rows" kernel existed."""
    from repro_torch.kernels import _build

    out = torch.empty((offsets.numel() - 1, feats.shape[1]), dtype=torch.float32,
                      device=feats.device)
    lib = _build.load("edge_block_spmm")
    rc = lib.atlas_segment_reduce(
        _build.ptr(feats), int(feats.dtype == torch.bfloat16), _build.ptr(src), _build.ptr(w),
        _build.ptr(offsets), _build.ptr(out), out.shape[0], feats.shape[0], src.numel(),
        feats.shape[1], _build.stream_handle(feats.device),
    )
    _build.check(rc, lib, "edge_block_spmm")
    return out


def _k1_both_routes(ops, plain=True):
    """K1 through the wrapper (asserting the route its rule picks) against
    the plain version (which wants well-formed offsets) and bitwise
    against the general kernel and itself."""
    path = ebs.route(ops[0].dtype, ops[0].shape[1], ops[0].data_ptr() % 16 == 0)
    counter = ebs.route_launches[path]
    before = counter.value
    got = ebs.segment_reduce_sorted(*ops)
    torch.cuda.synchronize()
    assert counter.value == before + 1
    if plain:
        torch.testing.assert_close(got, segment_reduce_sorted_ref(*ops), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, _k1_general(*ops))
    assert torch.equal(got, ebs.segment_reduce_sorted(*ops))
    return path


@pytest.mark.parametrize("n,d,m,num_dst", [c for c in SPMM_GRID if c[2]])
def test_k1_rows_route_equals_general_bitwise(cuda, n, d, m, num_dst):
    feats, src, dst, w = _spmm_inputs(n, d, m, num_dst, seed=m + d)
    _k1_both_routes(_sorted(feats, src, dst, w, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 172, 256])
def test_k1_rows_route_at_the_gnn_widths(cuda, d, dtype):
    """The e2e path's widths, with -1 sentinels, empty segments (every
    third destination receives nothing), segments of a few edges and
    power-law hubs: two neighbouring hubs of 5,000 and 3,000 edges and
    segments of 65 and 64 edges, on either side of the rows kernel's
    long-segment threshold."""
    rng = np.random.default_rng(d)
    n, num_dst = 300, 4000
    hubs = {1501: 5000, 1502: 3000, 1504: 65, 1505: 64}
    dst = np.concatenate([rng.integers(0, num_dst // 3, 5000) * 3]
                         + [np.full(k, v) for v, k in hubs.items()])
    src = rng.integers(0, n, dst.size).astype(np.int32)
    src[::13] = -1
    src[5::17] = n  # past the last row
    feats = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, dst.size).astype(np.float32)
    for v, k in hubs.items():  # mean-aggregation weights, 1/in-degree as the engine gives them
        w[dst == v] /= k
    ops = _sorted(feats, src, dst.astype(np.int32), w, cuda)
    ops[0] = ops[0].to(dtype)
    assert _k1_both_routes(ops) == "rows"


def test_k1_rows_route_with_offsets_out_of_order(cuda):
    """Offsets that decrease or leave [0, m] send their tile down the
    segment-by-segment loop; bounds clamp as in the general kernel.  A
    long, well-formed segment in such a tile stays in the loop when the
    tile's first and last offsets span few edges (segment 2) and goes to
    the long-segment pass when they span many (segment 35)."""
    feats, src, dst, w = _spmm_inputs(50, 64, 400, 100, seed=8)
    ops = _sorted(feats, src, dst, w, cuda)
    offsets = ops[3].clone()
    offsets[3], offsets[16] = 390, 10  # tile 0: segment 2 long, span 10
    offsets[35], offsets[36], offsets[40], offsets[48] = 100, 300, -5, 399  # tile 2: span > 64
    offsets[70] = 10_000
    ops[3] = offsets
    assert _k1_both_routes(ops, plain=False) == "rows"


def _k1_slab_order(feats, src, w, offsets, slab):
    """K1's order of the sum in numpy: each segment cut into slabs of
    ``slab`` edges from its first edge, each slab's f32 products summed in
    edge order from the first (``np.cumsum`` in f32), the partials added in
    slab order from slab 0's.  A source outside ``[0, n)`` adds nothing but
    counts towards its slab."""
    f = feats.float().cpu().numpy()
    s, wv, off = src.cpu().numpy(), w.cpu().numpy(), offsets.cpu().numpy()
    out = np.zeros((off.size - 1, f.shape[1]), np.float32)
    for row in range(off.size - 1):
        for s0 in range(off[row], off[row + 1], slab):
            e = np.arange(s0, min(s0 + slab, off[row + 1]))
            e = e[(s[e] >= 0) & (s[e] < f.shape[0])]
            part = (np.cumsum(wv[e, None] * f[s[e]], axis=0, dtype=np.float32)[-1] if e.size
                    else np.zeros(f.shape[1], np.float32))
            out[row] = part if s0 == off[row] else out[row] + part
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 172, 256])
def test_k1_long_segments_sum_in_slab_order(cuda, d, dtype):
    """Segments of L - 1, L, L + 1 and 2L + 1 edges (L = ``slab_edges()``)
    and a power-law hub of 300,001 edges weighted 1/in-degree, among short
    segments, with -1 and past-the-end sources: both routes bitwise the
    numpy emulation of the slab order and each other, each bitwise a
    repeat of itself, the segments of at most L edges bitwise one chain in
    edge order, the plain version within 1e-4/1e-5, and the split counters
    exact: the segments past L and their slabs."""
    slab = ebs.slab_edges()
    rng = np.random.default_rng(d + 1)
    n, num_dst = 5000, 3000
    # destinations the short segments (multiples of 3) leave alone
    longs = {1001: slab - 1, 1004: slab, 1007: slab + 1, 1010: 2 * slab + 1, 1501: 300_001}
    dst = np.concatenate([rng.integers(0, num_dst // 3, 20_000) * 3]
                         + [np.full(k, v) for v, k in longs.items()])
    src = rng.integers(0, n, dst.size).astype(np.int32)
    src[::13] = -1
    src[5::17] = n  # past the last row
    feats = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, dst.size).astype(np.float32)
    for v, k in longs.items():
        w[dst == v] /= k
    w[dst == 1501] = np.float32(1 / longs[1501])  # the hub: mean aggregation's 1/in-degree
    ops = _sorted(feats, src, dst.astype(np.int32), w, cuda)
    ops[0] = ops[0].to(dtype)
    ebs.split_counts.reset()
    got = ebs.segment_reduce_sorted(*ops)
    split = [k for k in longs.values() if k > slab]
    assert ebs.split_counts.value == (len(split), sum(-(-k // slab) for k in split))
    assert _k1_both_routes(ops) == "rows"
    got = got.cpu().numpy()
    assert np.array_equal(got, _k1_slab_order(*ops, slab))
    assert np.array_equal(_k1_general(*ops).cpu().numpy(), got)
    one_chain = _k1_slab_order(*ops, ops[1].numel() + 1)
    short = np.diff(ops[3].cpu().numpy()) <= slab
    assert np.array_equal(got[short], one_chain[short])


def test_k1_rows_route_with_overlapping_long_segments(cuda):
    """Offsets that give eight segments the same 3L edges, in one tile
    whose first and last offsets span them: the scratch, sized for
    disjoint segments, holds the slabs of one, and pass 1 sums the others
    in the same slab order.  Bitwise the general kernel and itself; one
    segment of three slabs split on each of the two rows-route calls."""
    slab = ebs.slab_edges()
    feats, src, dst, w = _spmm_inputs(50, 64, 3 * slab, 1, seed=9)
    ops = _sorted(feats, src, dst, w, cuda)
    ops[3] = torch.tensor([0, 3 * slab] * 8, dtype=torch.int32, device=cuda)
    ebs.split_counts.reset()
    assert _k1_both_routes(ops, plain=False) == "rows"
    assert ebs.split_counts.value == (2, 6)


def test_k1_split_counts_nothing_without_long_segments(cuda):
    """100,000 uniform edges over 10,000 segments (none near L edges): the
    rows route's second launch runs and finds nothing to split."""
    feats, src, dst, w = _spmm_inputs(1000, 128, 100_000, 10_000, seed=5)
    ops = _sorted(feats, src, dst, w, cuda)
    ebs.split_counts.reset()
    assert _k1_both_routes(ops) == "rows"
    assert ebs.split_counts.value == (0, 0)


@pytest.mark.parametrize("d,offset", [(6, 0), (36, 1)])
def test_k1_widths_and_views_that_take_the_general_route(cuda, d, offset):
    """d = 6 has no whole 16-byte packs; a 36-wide view one float into its
    buffer is not 16-byte aligned: both take the general kernel."""
    feats, src, dst, w = _spmm_inputs(40, d, 300, 60, seed=d)
    ops = _sorted(feats, src, dst, w, cuda)
    flat = torch.empty(offset + feats.size, device=cuda)
    flat[offset:] = ops[0].flatten()
    ops[0] = flat[offset:].view(40, d)
    assert _k1_both_routes(ops) == "general"


def test_k1_rejects_cpu_cuda_mix(cuda):
    feats, src, dst, w = _spmm_inputs(8, 4, 10, 5, seed=0)
    ops = _sorted(feats, src, dst, w, cuda)
    ops[1] = ops[1].cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        ebs.segment_reduce_sorted(*ops)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m", K2_GRID)
def test_k2_kernel_matches_plain(cuda, activation, dtype, n, k, m):
    g = torch.Generator().manual_seed(n + k + m)
    x = torch.randn(n, k, generator=g).to(cuda, dtype)
    w = (torch.randn(k, m, generator=g) / k**0.5).to(cuda, dtype)
    b = torch.randn(m, generator=g).to(cuda, dtype)
    counter = fg.route_launches[fg.route(dtype, k, m)]
    before, before_route = fg.launches.value, counter.value
    got = fg.fused_graduate(x, w, b, activation)
    again = fg.fused_graduate(x, w, b, activation)
    torch.cuda.synchronize()
    assert fg.launches.value == before + 2
    assert counter.value == before_route + 2
    tol = K2_TOL[dtype]
    torch.testing.assert_close(
        got.float(), fg.fused_graduate_ref(x, w, b, activation).float(),
        rtol=tol, atol=tol,
    )
    assert torch.equal(got, again)


def test_k2_unaligned_bf16_takes_the_cuda_core_route(cuda):
    """x starting 2 bytes into its buffer breaks TMA's 16-byte rule: the
    wrapper's route sends it to the CUDA-core kernel, which reads it."""
    g = torch.Generator().manual_seed(5)
    flat = torch.randn(1 + 96 * 64, generator=g).to(cuda, torch.bfloat16)
    x = flat[1:].view(96, 64)
    w = (torch.randn(64, 128, generator=g) / 8).to(cuda, torch.bfloat16)
    b = torch.randn(128, generator=g).to(cuda, torch.bfloat16)
    before = fg.cuda_core_launches.value
    got = fg.fused_graduate(x, w, b, "relu")
    torch.cuda.synchronize()
    assert fg.cuda_core_launches.value == before + 1
    torch.testing.assert_close(got.float(), fg.fused_graduate_ref(x, w, b, "relu").float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind,calls", [("gcn", 1), ("gin", 2)])
def test_layer_update_on_card_matches_cpu(cuda, kind, calls):
    """GCN's and GIN's graduation transform at the e2e widths on the card
    (K2 once a layer for GCN, twice for GIN's MLP, all on the CUDA cores
    in f32) against the CPU's plain versions on the same rows, at a full
    graduation buffer's worth of rows and a partial one."""
    specs = init_gnn_params(kind, [128, 256, 256, 172], seed=3, gin_eps=0.1)
    rng = np.random.default_rng(4)
    for spec in specs:
        host_spec, card_spec = spec.to("cpu"), spec.to(cuda)
        for n in (AtlasConfig.graduation_rows, 3392):
            agg = torch.from_numpy(rng.standard_normal((n, spec.hot_width)).astype(np.float32))
            want = layer_update(host_spec, agg)
            before = (fg.launches.value, fg.cuda_core_launches.value)
            got = layer_update(card_spec, agg.to(cuda))
            torch.cuda.synchronize()
            assert (fg.launches.value, fg.cuda_core_launches.value) == (
                before[0] + calls, before[1] + calls)
            assert got.shape == (n, spec.out_dim)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pipeline,depth", [("staged", 1), ("staged", 2), ("serial", 2)])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_engine_on_card_equals_cpu_run_exactly(cuda, tmp_path, kind, pipeline, depth):
    """Exact-arithmetic graph: the CUDA run (K1 + K2, staged ring or
    serial pipeline, side streams, pinned buffers in and pinned partials
    out) gives the CPU run's bits."""
    csr, feats, specs = exact.exact_graph_and_specs(1024, 16, kind=kind)
    out = {}
    for backend in ("cpu", "cuda"):
        store = GraphStore.create(str(tmp_path / backend), csr, feats, order="at")
        cfg = AtlasConfig(backend=backend, chunk_bytes=128 * 16 * 4, hot_slots=200,
                          pipeline=pipeline, staging_depth=depth)
        k1, k2 = ebs.launches.value, fg.launches.value
        with AtlasSession(store, config=cfg) as s:
            result = s.infer(specs)
        if backend == "cuda":
            assert ebs.launches.value > k1 and fg.launches.value > k2
        out[backend] = spills_to_dense(result.final.spills, 1024, specs[-1].out_dim)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])


@pytest.mark.parametrize("pipeline", ["staged", "serial"])
def test_staging_copies_are_timed_on_the_card(cuda, tmp_path, pipeline):
    """Each layer's h2d copies of the chunk operands and d2h copy of the
    partials, timed by CUDA events on the aggregator's stream: above 0 and
    below the layer's wall on the card, 0.0 on the CPU backend."""
    csr, feats, specs = exact.exact_graph_and_specs(1024, 16, kind="sage")
    for backend in ("cpu", "cuda"):
        store = GraphStore.create(str(tmp_path / backend), csr, feats, order="at")
        cfg = AtlasConfig(backend=backend, chunk_bytes=128 * 16 * 4, hot_slots=200,
                          pipeline=pipeline)
        with AtlasSession(store, config=cfg) as s:
            metrics = s.infer(specs).metrics
        for m in metrics:
            if backend == "cuda":
                assert 0.0 < m.h2d_device_seconds < m.seconds
                assert 0.0 < m.d2h_device_seconds < m.seconds
            else:
                assert m.h2d_device_seconds == m.d2h_device_seconds == 0.0


def test_infer_on_card_then_publish_and_serve(cuda, tmp_path):
    """infer on the card (K1 + K2), then publish: both reader paths serve
    the rows of spills_to_dense at the store's permutation, bit for bit."""
    csr, feats, specs = exact.exact_graph_and_specs(1024, 16, kind="sage")
    store = GraphStore.create(str(tmp_path / "store"), csr, feats, order="at")
    cfg = AtlasConfig(backend="cuda", chunk_bytes=128 * 16 * 4, hot_slots=200)
    k1, k2 = ebs.launches.value, fg.launches.value
    with AtlasSession(store, config=cfg) as s:
        final = s.infer(specs).final
        assert ebs.launches.value > k1 and fg.launches.value > k2
        dense = spills_to_dense(final.spills, 1024, final.dim)
        s.publish(final, block_rows=64)
        ids = np.random.default_rng(5).integers(0, 1024, size=3000)
        expect = dense[store.new_of_old()[ids]]
        for fast_path in (True, False):
            with s.reader(final.layer, fast_path=fast_path,
                          cache_bytes=None if fast_path else 1 << 16) as r:
                assert r.fast_path == fast_path
                np.testing.assert_array_equal(r.lookup(ids), expect)


def _dist_cfg():
    return AtlasConfig(backend="cuda", chunk_bytes=128 * 16 * 4, hot_slots=200)


@pytest.mark.parametrize("mode", ["thread-local", "thread-mesh", "process"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_dist_on_card_equals_single_machine(cuda, tmp_path, kind, mode):
    """Two shards on one card — shard threads launching K1 and K2 at once
    on their own streams, the mesh exchange's copies on cuda:0, or two
    worker processes each with its own context: run twice, each run gives
    the single-machine run's bits on the card."""
    csr, feats, specs = exact.exact_graph_and_specs(2048, 16, kind=kind)
    store = GraphStore.create(str(tmp_path / "store"), csr, feats, order="at")
    with AtlasSession(store, config=_dist_cfg(), workdir=str(tmp_path / "single")) as s:
        ref = spills_to_dense(s.infer(specs).final.spills, 2048, specs[-1].out_dim)
    workers, exchange = ("process", "local") if mode == "process" else mode.split("-")
    runs = []
    for run in range(2):
        k1, rows, k2 = ebs.launches.value, ebs.rows_launches.value, fg.launches.value
        with DistSession(store, shards=2, config=_dist_cfg(), workers=workers,
                         exchange=exchange, mesh_devices=["cuda:0"] * 2,
                         workdir=str(tmp_path / f"dist{run}")) as dist:
            result = dist.infer(specs)
        if workers == "thread":
            assert ebs.launches.value > k1 and fg.launches.value > k2
            assert ebs.rows_launches.value - rows == ebs.launches.value - k1
        assert all(r["exchange"]["recv_records"] > 0
                   for reports in result.shard_reports.values() for r in reports)
        runs.append(spills_to_dense(result.final.spills, 2048, specs[-1].out_dim))
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], ref)


@pytest.mark.parametrize("fn", ["layerwise_gather", "vertexwise_gather"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_gather_on_card_equals_cpu_run(cuda, kind, fn):
    """The gather baselines on the card (K1 segment sums, K2 transforms)
    give their CPU run's bits on an exact graph, twice, with the same I/O
    statistics."""
    csr, feats, specs = exact.exact_graph_and_specs(1500, 16, kind=kind)
    want, wstats = getattr(gather_ref, fn)(csr, feats, specs, batch_size=256, device="cpu")
    for _ in range(2):
        k1, k2 = ebs.launches.value, fg.launches.value
        got, stats = getattr(gather_ref, fn)(csr, feats, specs, batch_size=256, device=cuda)
        assert ebs.launches.value > k1 and fg.launches.value > k2
        np.testing.assert_array_equal(got, want)
        assert stats == wstats


@pytest.mark.parametrize("step", ["combined", "baseline-1", "baseline-3"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("shape,axes", [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
                                        ((4, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_mesh_on_card_is_the_dense_reference_bitwise(cuda, shape, axes, kind, step):
    """The mesh steps with every position on cuda:0 (the baseline with 1 and
    3 chunks, sage with has_self): K1 on its rows route and K2 launching,
    every padded row bitwise the dense reference's CPU run, twice."""
    mesh = make_mesh(shape, axes, devices="cuda:0")
    csr, feats, specs = exact.exact_graph_and_specs(2048, 16, kind=kind)
    build = dist_mesh.build_combined_plan if step == "combined" else dist_mesh.build_edge_plan
    plan = build(csr, mesh.num_shards, kind)
    x = dist_mesh.pad_features(feats, plan)
    want = dense_reference(dist_mesh.pad_graph(csr, plan), x, specs, device="cpu")
    chunks = 1 if step == "combined" else int(step.split("-")[1])
    for _ in range(2):
        k1, rows, k2 = ebs.launches.value, ebs.rows_launches.value, fg.launches.value
        got, _ = dist_mesh.run_layers(mesh, plan, torch.from_numpy(x), specs, chunks=chunks)
        assert ebs.launches.value > k1 and fg.launches.value > k2
        assert ebs.rows_launches.value - rows == ebs.launches.value - k1
        np.testing.assert_array_equal(got.numpy(), want)


def _attn_inputs(b, hq, hkv, s, d, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [
        torch.randn(b, h, s, d, generator=g).to(device, dtype) for h in (hq, hkv, hkv)
    ]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d", ATTN_GRID)
def test_k3_kernel_matches_plain(cuda, b, hq, hkv, s, d, dtype, causal):
    q, k, v = _attn_inputs(b, hq, hkv, s, d, dtype, cuda, seed=s + d + hq)
    counter = fa.route_launches[fa.route(dtype, d)]
    before, before_route = fa.launches.value, counter.value
    got = fa.flash_attention(q, k, v, causal)
    again = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches.value == before + 2
    assert counter.value == before_route + 2
    assert got.dtype == dtype and got.shape == q.shape
    tol = K3_TOL[dtype]
    torch.testing.assert_close(
        got.float(), flash_attention_ref(q, k, v, causal).float(), rtol=tol, atol=tol
    )
    assert torch.equal(got, again)


def _ssd_inputs(bh, s, p, n, heads_per_bc, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(bh, s, p, generator=g)
    a = torch.rand(bh, s, generator=g) * 0.3 + 0.7
    b = torch.randn(bh // heads_per_bc, s, n, generator=g) * 0.3
    c = torch.randn(bh // heads_per_bc, s, n, generator=g) * 0.3
    return x.to(device, dtype), a.to(device), b.to(device, dtype), c.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,n,chunk,hpb", SSD_GRID)
def test_k4_kernel_matches_plain(cuda, bh, s, p, n, chunk, hpb, dtype):
    x, a, b, c = _ssd_inputs(bh, s, p, n, hpb, dtype, cuda, seed=s + p + n)
    before = sc.launches.value
    got = sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb)
    again = sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb)
    torch.cuda.synchronize()
    assert sc.launches.value == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    tol = K4_TOL[dtype]
    want = ssd_scan_ref(x, a, b, c, chunk, hpb)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,n,chunk,hpb", SSD_GRID)
def test_k4_final_state_matches_plain(cuda, bh, s, p, n, chunk, hpb, dtype):
    """The state the kernel writes after the last step (the prefill's
    handoff to the decode cache), against the plain version's, in f32."""
    x, a, b, c = _ssd_inputs(bh, s, p, n, hpb, dtype, cuda, seed=s + p + n + 1)
    got, state = sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb, return_state=True)
    torch.cuda.synchronize()
    assert state.dtype == torch.float32 and state.shape == (bh, p, n)
    assert torch.equal(got, sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb))
    _, want = ssd_scan_ref(x, a, b, c, chunk, hpb, return_state=True)
    torch.testing.assert_close(state, want, rtol=K4_TOL[torch.float32], atol=K4_TOL[torch.float32])


def test_k4_state_carries_across_chunks(cuda):
    x, a, b, c = _ssd_inputs(2, 256, 16, 32, 1, torch.float32, cuda, seed=4)
    full = sc.ssd_scan(x, a, b, c, 128)
    first = sc.ssd_scan(x[:, :128].contiguous(), a[:, :128].contiguous(),
                        b[:, :128].contiguous(), c[:, :128].contiguous(), 128)
    torch.testing.assert_close(full[:, :128], first, rtol=1e-5, atol=1e-5)
    second = sc.ssd_scan(*(t[:, 128:].contiguous() for t in (x, a, b, c)), 128)
    assert not torch.allclose(full[:, 128:], second, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bh,s,n,chunk,hpb", SSD_TC_GRID)
def test_k4_tensor_core_route_matches_plain(cuda, bh, s, n, chunk, hpb):
    """bf16 at P = 64 runs the three-pass wgmma route: y at the bf16 bar,
    the final state at the f32 bar (hi + lo operands), bitwise repeats."""
    p, dtype = 64, torch.bfloat16
    assert sc.route(dtype, p, n, chunk) == "tensor_core"
    x, a, b, c = _ssd_inputs(bh, s, p, n, hpb, dtype, cuda, seed=s + n + chunk)
    before, before_tc = sc.launches.value, sc.tensor_core_launches.value
    got, state = sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb, return_state=True)
    again, state_again = sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb, return_state=True)
    torch.cuda.synchronize()
    assert sc.launches.value == before + 2
    assert sc.tensor_core_launches.value == before_tc + 2
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got.float()).all()
    want, want_state = ssd_scan_ref(x, a, b, c, chunk, hpb, return_state=True)
    tol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    tol = K4_TOL[torch.float32]
    torch.testing.assert_close(state, want_state, rtol=tol, atol=tol)
    assert torch.equal(got, again) and torch.equal(state, state_again)
    assert torch.equal(got, sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=hpb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(n, d) for d in (128, 2048, 2560, 4096, 5120) for n in (1, 3, 2049)]
                         + [(4100, 4096)]
                         + [(n, d) for d in (3584, 7168) for n in (1, 3, 2049, 4100)])
def test_k5_resident_route_matches_plain(cuda, n, d, dtype):
    """The served and trained widths hold their rows in registers: one
    row, a few, and more rows than the grid has threads for (the
    grid-stride loop); qwen2-7b's 3584 and arctic's 7168 in seven and
    fourteen warps a row."""
    assert rn.route(dtype, d) == "resident"
    g = torch.Generator().manual_seed(n + d)
    x = torch.randn(n, d, generator=g).to(cuda, dtype)
    scale = (torch.randn(d, generator=g) * 0.1).to(cuda, dtype)
    before, before_route = rn.launches.value, rn.resident_launches.value
    got = rn.rms_norm(x, scale)
    again = rn.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert rn.launches.value == before + 2
    assert rn.resident_launches.value == before_route + 2
    tol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), rms_norm_ref(x, scale).float(), rtol=tol, atol=tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", RMS_GRID)
def test_k5_kernel_matches_plain(cuda, n, d, dtype):
    g = torch.Generator().manual_seed(n * 7 + d)
    x = torch.randn(n, d, generator=g).to(cuda, dtype)
    scale = (torch.randn(d, generator=g) * 0.1).to(cuda, dtype)
    before = rn.launches.value
    got = rn.rms_norm(x, scale)
    again = rn.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert rn.launches.value == before + 2
    tol = K5_TOL[dtype]
    torch.testing.assert_close(
        got.float(), rms_norm_ref(x, scale).float(), rtol=tol, atol=tol
    )
    assert torch.equal(got, again)


def test_k5_unaligned_rows_take_the_scalar_path(cuda):
    """A view that starts 4 bytes into its buffer cannot take 16-byte
    loads; the wrapper falls back to the kernel's one-value loads."""
    g = torch.Generator().manual_seed(3)
    flat = torch.randn(1 + 6 * 256, generator=g).to(cuda)
    x = flat[1:].view(6, 256)
    scale = torch.randn(256, generator=g).to(cuda) * 0.1
    torch.testing.assert_close(rn.rms_norm(x, scale), rms_norm_ref(x, scale),
                               rtol=1e-5, atol=1e-5)


def test_k5_unaligned_served_width_takes_the_general_route(cuda):
    """A 5120-wide view 4 bytes into its buffer breaks the resident
    route's 16-byte packs: the general kernel's one-value loads take it."""
    g = torch.Generator().manual_seed(4)
    flat = torch.randn(1 + 3 * 5120, generator=g).to(cuda)
    x = flat[1:].view(3, 5120)
    scale = torch.randn(5120, generator=g).to(cuda) * 0.1
    assert rn.route(x.dtype, 5120, aligned=x.data_ptr() % 16 == 0) == "general"
    before = rn.general_launches.value
    got = rn.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert rn.general_launches.value == before + 1
    torch.testing.assert_close(got, rms_norm_ref(x, scale), rtol=1e-5, atol=1e-5)


def test_new_kernels_reject_cpu_cuda_mix(cuda):
    q, k, v = _attn_inputs(1, 2, 1, 8, 16, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="one CUDA device"):
        rn.rms_norm(q[0, 0], torch.zeros(16))
    x, a, b, c = _ssd_inputs(2, 16, 4, 8, 1, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        sc.ssd_scan(x, a.cpu(), b, c, 16)


@pytest.mark.parametrize("arch", list_archs())
def test_lm_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """The smoke-size model through K3/K4/K5/K6 on the card against the same
    model on the CPU (the plain versions), f32 at 1e-4; the modality stubs
    prefill and replay [B, S, d_model] embeddings."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = get_smoke_config(arch)
    host = lm.init_params(cfg, seed=0, device="cpu")
    card = lm._tree_map(lambda t: t.to(cuda), host)
    gen = torch.Generator().manual_seed(1)
    if cfg.input_mode == "tokens":
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    else:
        tokens = torch.randn((2, 32, cfg.d_model), generator=gen)
    counts = (fa.launches.value, sc.launches.value, rn.launches.value, k6.launches.value)
    out = {}
    for name, params, dev in (("cpu", host, torch.device("cpu")), ("cuda", card, cuda)):
        inputs = tokens.to(dev)
        logits, _ = lm.prefill(params, cfg, inputs)
        replay = lm.init_cache(cfg, 2, 32, dev)
        for t in range(32):  # strided slices of the inputs on the device, as the engine feeds
            step, replay = lm.decode_step(params, cfg, replay, inputs[:, t:t + 1])
        out[name] = (logits.cpu(), step.cpu())
    torch.cuda.synchronize()
    assert rn.launches.value > counts[2]
    if cfg.family == "ssm":
        assert sc.launches.value > counts[1]
    else:
        assert fa.launches.value > counts[0]
    if cfg.family == "hybrid":
        assert k6.launches.value > counts[3]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cuda"][0], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------- backward kernels

K3_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d", ATTN_GRID)
def test_k3_bwd_matches_plain(cuda, b, hq, hkv, s, d, dtype, causal):
    q, k, v = _attn_inputs(b, hq, hkv, s, d, dtype, cuda, seed=s + d)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda).to(dtype)
    lse = torch.empty((b * hq, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, causal, lse=lse)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal)), "lse changed the output"
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, causal), rtol=1e-5, atol=1e-5)
    route = fa.bwd_route(q, k, v, out, do)
    assert route == fa.route(dtype, d)  # bf16 at d 64/128 on the tensor cores
    counter = fa.bwd_route_launches[route]
    before, before_route = fa.bwd_launches.value, counter.value
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert fa.bwd_launches.value == before + 1
    assert counter.value == before_route + 1
    want = flash_attention_bwd_ref(q, k, v, out, do, causal)
    torch.cuda.synchronize()
    tol = K3_BWD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "K3 bwd is not bitwise repeatable"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 128), (3, 5120), (2049, 128), (257, 5120), (40, 300), (5, 2560)])
def test_k5_bwd_matches_plain(cuda, n, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    scale = (0.1 * torch.randn((d,), generator=gen, device=cuda)).to(dtype)
    dy = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    route = rn.bwd_route(x, scale, dy)
    assert route == rn.route(dtype, d)  # 128, 2048, 2560, 4096 and 5120 resident, the rest general
    counter = rn.bwd_route_launches[route]
    before, before_route = rn.bwd_launches.value, counter.value
    dx, ds = rn.rms_norm_bwd(x, scale, dy)
    assert rn.bwd_launches.value == before + 1
    assert counter.value == before_route + 1
    want = rms_norm_bwd_ref(x, scale, dy)
    torch.cuda.synchronize()
    assert dx.dtype == ds.dtype == dtype
    torch.testing.assert_close(dx.float(), want[0].float(), rtol=K5_TOL[dtype], atol=K5_TOL[dtype])
    # dscale sums n rows of either sign in another order: held relative to its largest value
    err = float((ds.float() - want[1].float()).abs().max())
    assert err <= K5_TOL[dtype] * float(want[1].float().abs().max()), err
    again = rn.rms_norm_bwd(x, scale, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds), "K5 bwd is not bitwise repeatable"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 5, 8])
@pytest.mark.parametrize("s", [1, 70, 200, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_k3_bwd_tensor_core_route_matches_plain(cuda, d, s, group, causal):
    """bf16 at head dims 64 and 128 (the tensor-core route): one row, ragged
    tiles, [train]'s length; MHA, qwen3's group of 5 and a group of 8 summed
    inside one dK/dV block."""
    hkv = 2 if s < 2048 else 1
    q, k, v = _attn_inputs(1, hkv * group, hkv, s, d, torch.bfloat16, cuda, seed=s + d + group)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(s),
                     device=cuda).to(torch.bfloat16)
    lse = torch.empty((hkv * group, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, causal, lse=lse)
    assert fa.bwd_route(q, k, v, out, do) == "tensor_core"
    before = fa.bwd_tensor_core_launches.value
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert fa.bwd_tensor_core_launches.value == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, do, causal)
    torch.cuda.synchronize()
    tol = K3_BWD_TOL[torch.bfloat16]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "not bitwise repeatable"


def test_k3_bwd_unaligned_bf16_takes_the_cuda_core_route(cuda):
    q, k, v = _attn_inputs(1, 4, 2, 70, 128, torch.bfloat16, cuda, seed=1)
    lse = torch.empty((4, 70), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, True, lse=lse)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    do = buf[1:q.numel() + 1].view(q.shape)  # 2 bytes past a 16-byte boundary
    do.copy_(torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(2),
                         device=cuda))
    assert fa.bwd_route(q, k, v, out, do) == "cuda_core"
    before = fa.bwd_cuda_core_launches.value
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert fa.bwd_cuda_core_launches.value == before + 1
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, out, do, True)):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(n, d) for d in (128, 2048, 2560, 4096, 5120) for n in (1, 3, 2049)]
                         + [(40000, 128), (4100, 2048), (4100, 2560), (4100, 4096), (4100, 5120)]
                         + [(n, d) for d in (3584, 7168) for n in (1, 3, 2049, 4100)])
def test_k5_bwd_resident_route_matches_plain(cuda, n, d, dtype):
    """The resident backward at its seven widths: fewer rows than blocks,
    one step, and many rows per block before dscale's per-block sums
    ([train]'s 4,096 rows plus a ragged step; 40,000 of the 128-wide)."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    scale = (0.1 * torch.randn((d,), generator=gen, device=cuda)).to(dtype)
    dy = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    assert rn.bwd_route(x, scale, dy) == "resident"
    before = rn.bwd_resident_launches.value
    dx, ds = rn.rms_norm_bwd(x, scale, dy)
    assert rn.bwd_resident_launches.value == before + 1
    want = rms_norm_bwd_ref(x, scale, dy)
    torch.cuda.synchronize()
    tol = K5_TOL[dtype]
    torch.testing.assert_close(dx.float(), want[0].float(), rtol=tol, atol=tol)
    err = float((ds.float() - want[1].float()).abs().max())
    assert err <= tol * float(want[1].float().abs().max()), err
    again = rn.rms_norm_bwd(x, scale, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], ds), "not bitwise repeatable"


def test_k5_bwd_unaligned_served_width_takes_the_general_route(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn((3 * 5120 + 8,), generator=gen, device=cuda).to(torch.bfloat16)
    x = buf[1:3 * 5120 + 1].view(3, 5120)  # 2 bytes past a 16-byte boundary
    scale = (0.1 * torch.randn((5120,), generator=gen, device=cuda)).to(torch.bfloat16)
    dy = torch.randn((3, 5120), generator=gen, device=cuda).to(torch.bfloat16)
    assert rn.bwd_route(x, scale, dy) == "general"
    before = rn.bwd_general_launches.value
    dx, ds = rn.rms_norm_bwd(x, scale, dy)
    assert rn.bwd_general_launches.value == before + 1
    want = rms_norm_bwd_ref(x, scale, dy)
    torch.testing.assert_close(dx.float(), want[0].float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(ds.float(), want[1].float(), rtol=2e-2, atol=2e-2)


def test_ops_under_grad_run_the_backward_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((1, h, 70, 64), generator=gen, device=cuda) for h in (4, 2, 2))
    scale = 0.1 * torch.randn((64,), generator=gen, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, scale)]
    counts = (fa.bwd_launches.value, rn.bwd_launches.value)
    y = ops.rms_norm(ops.attention(*leaves[:3]), leaves[3])
    got = torch.autograd.grad(y.square().sum(), leaves)
    assert (fa.bwd_launches.value, rn.bwd_launches.value) == (counts[0] + 1, counts[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v, scale)]
    yp = rms_norm_ref(flash_attention_ref(*plain[:3]), plain[3])
    want = torch.autograd.grad(yp.square().sum(), plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_ssd_under_grad_on_the_card_raises(cuda):
    """Under grad the final state has no gradient: asking for it raises."""
    x, a, b, c = _ssd_inputs(2, 16, 4, 8, 1, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError, match="return_state"):
        ops.ssd(x.requires_grad_(), a, b, c, 16, return_state=True)
    with torch.no_grad():
        ops.ssd(x, a, b, c, 16, return_state=True)  # serving still runs K4


def _ssd_bwd_check(x, a, b, c, dy, chunk, hpb):
    """K4's backward on the card against the plain backward, each gradient
    within the bar of its largest magnitude, on the route ``bwd_route``
    names, and bitwise repeatable.  Returns the route."""
    route = sc.bwd_route(x.dtype, x.shape[-1], b.shape[-1], chunk)
    counter = sc.bwd_route_launches[route]
    before, before_route = sc.bwd_launches.value, counter.value
    got = sc.ssd_scan_bwd(x, a, b, c, dy, chunk, heads_per_bc=hpb)
    assert sc.bwd_launches.value == before + 1
    assert counter.value == before_route + 1, route
    want = ssd_scan_bwd_ref(x, a, b, c, dy, chunk, hpb)
    torch.cuda.synchronize()
    tol = K4_TOL[x.dtype]
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)
    again = sc.ssd_scan_bwd(x, a, b, c, dy, chunk, heads_per_bc=hpb)
    assert all(torch.equal(g, r) for g, r in zip(got, again)), "K4 bwd is not bitwise repeatable"
    return route


def _k4_bwd_cuda_core(x, a, b, c, dy, chunk, hpb):
    """K4's CUDA-core backward through its C entry, on inputs the wrapper
    may send to the tensor cores: the other route on the same inputs."""
    from repro_torch.kernels import _build

    bh, s, p = x.shape
    n, nc = b.shape[-1], s // chunk
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((bh, s), dtype=torch.float32, device=x.device)
    states = torch.empty((2, bh, nc, p, n), dtype=torch.float32, device=x.device)
    partials = torch.empty((2, bh, s, n), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_chunk")
    rc = lib.atlas_ssd_chunk_bwd(
        *(_build.ptr(t) for t in (x, a, b, c, dy, dx, da, db, dc, states[0], states[1],
                                  partials[0], partials[1])),
        bh, s, p, n, chunk, hpb, int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, lib, "ssd_chunk")
    return dx, da, db, dc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,n,chunk,hpb", SSD_GRID + [(160, 512, 64, 128, 256, 80)])
def test_k4_bwd_matches_plain(cuda, bh, s, p, n, chunk, hpb, dtype):
    x, a, b, c = _ssd_inputs(bh, s, p, n, hpb, dtype, cuda, seed=s + p + n)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(s)).to(cuda, dtype)
    _ssd_bwd_check(x, a, b, c, dy, chunk, hpb)


@pytest.mark.parametrize("lo,hi", [(0.995, 1.0), (0.05, 0.06)])
def test_k4_bwd_decays_near_one_and_near_zero(cuda, lo, hi):
    """a close to 1 (long memory) and close to 0.05 (exp(cl) underflows
    within a chunk of 256), both at init of mamba2-2.7b, on the tensor
    cores."""
    x, _, b, c = _ssd_inputs(8, 768, 64, 128, 4, torch.bfloat16, cuda, seed=7)
    g = torch.Generator().manual_seed(8)
    a = (torch.rand(8, 768, generator=g) * (hi - lo) + lo).to(cuda)
    dy = torch.randn(x.shape, generator=g).to(cuda, torch.bfloat16)
    assert _ssd_bwd_check(x, a, b, c, dy, 256, 4) == "tensor_core"


@pytest.mark.parametrize("bh,s,n,chunk,hpb", SSD_TC_GRID + [(160, 512, 128, 256, 80)])
def test_k4_bwd_tensor_core_route_matches_plain(cuda, bh, s, n, chunk, hpb):
    """bf16 at P = 64 on the tensor cores: three chunks (both state passes
    carry twice), chunks of 64, N = 64, a head group of 3, and [train]'s
    80 heads a b/c row (10 groups of 8)."""
    x, a, b, c = _ssd_inputs(bh, s, 64, n, hpb, torch.bfloat16, cuda, seed=s + n + chunk)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(s + 1)).to(
        cuda, torch.bfloat16)
    assert _ssd_bwd_check(x, a, b, c, dy, chunk, hpb) == "tensor_core"


@pytest.mark.parametrize("bh,s,n,chunk,hpb", [(160, 512, 128, 256, 80), (4, 192, 64, 64, 4)])
def test_k4_bwd_routes_agree(cuda, bh, s, n, chunk, hpb):
    """The tensor-core and CUDA-core backward on the same bf16 inputs: each
    gradient within the bf16 bar of the larger magnitude of the two."""
    x, a, b, c = _ssd_inputs(bh, s, 64, n, hpb, torch.bfloat16, cuda, seed=s + 3)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(s + 4)).to(
        cuda, torch.bfloat16)
    before = sc.bwd_tensor_core_launches.value
    fast = sc.ssd_scan_bwd(x, a, b, c, dy, chunk, heads_per_bc=hpb)
    assert sc.bwd_tensor_core_launches.value == before + 1
    slow = _k4_bwd_cuda_core(x, a, b, c, dy, chunk, hpb)
    torch.cuda.synchronize()
    for name, f, o in zip(("dx", "da", "db", "dc"), fast, slow):
        top = max(float(f.float().abs().max()), float(o.float().abs().max()))
        err = float((f.float() - o.float()).abs().max())
        assert err <= K4_TOL[torch.bfloat16] * top, (name, err)


def test_ssd_under_grad_runs_the_backward_kernel(cuda):
    x, a, b, c = _ssd_inputs(6, 96, 8, 16, 3, torch.float32, cuda, seed=4)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    before = sc.bwd_launches.value
    got = torch.autograd.grad(ops.ssd(*leaves, 32, heads_per_bc=3).square().sum(), leaves)
    assert sc.bwd_launches.value == before + 1
    plain = [t.clone().requires_grad_() for t in (x, a, b, c)]
    want = torch.autograd.grad(ssd_scan_ref(*plain, 32, 3).square().sum(), plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_bitwise_on_card(cuda, dtype):
    """The MoE layer's forward and gradients at deepseek-moe-16b's routing
    (64 experts, top 6, drops at factor 1.25) are the same bits on two runs
    on the card, and in f32 match the CPU run."""
    from repro_torch.models.moe import moe_forward

    g = torch.Generator().manual_seed(9)
    d, f, e = 256, 128, 64
    host = {"router": torch.randn(d, e, generator=g) * d**-0.5,
            "gate": torch.randn(e, d, f, generator=g) * d**-0.5,
            "up": torch.randn(e, d, f, generator=g) * d**-0.5,
            "down": torch.randn(e, f, d, generator=g) * f**-0.5}
    x = torch.randn(2, 512, d, generator=g)
    dy = torch.randn(2, 512, d, generator=g)

    def run(device, dt):
        leaves = {k: (v if k == "router" else v.to(dt)).to(device).requires_grad_()
                  for k, v in host.items()}
        xx = x.to(device, dt).requires_grad_()
        out = moe_forward(leaves, xx, top_k=6, capacity_factor=1.25)
        grads = torch.autograd.grad((out.float() * dy.to(device)).sum(),
                                    [leaves[k] for k in sorted(leaves)] + [xx])
        return [out.detach(), *grads]

    first, second = run(cuda, dtype), run(cuda, dtype)
    assert all(torch.equal(a, b) for a, b in zip(first, second)), "MoE layer not bitwise repeatable"
    if dtype == torch.float32:
        for a, b in zip(first, run("cpu", dtype)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _train_setup(cuda, arch="qwen3-14b"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    host = init_train_state(cfg, opt_cfg, seed=0, device="cpu")
    batches = [make_global_batch(0, i, 2, 64, cfg.vocab_size, device="cpu") for i in range(3)]
    return cfg, host, batches, make_train_step(cfg, opt_cfg)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_train_step_on_card_matches_cpu(cuda):
    from repro_torch.train.optimizer import tree_leaves

    _, host, batches, step = _train_setup(cuda)
    card = _to(host, cuda)
    counts = (fa.bwd_launches.value, rn.bwd_launches.value)
    for batch in batches:
        host, hm = step(host, batch)
        card, cm = step(card, _to(batch, cuda))
        torch.testing.assert_close(cm["loss"].cpu(), hm["loss"], rtol=1e-5, atol=1e-5)
    assert fa.bwd_launches.value > counts[0] and rn.bwd_launches.value > counts[1]
    for a, b in zip(tree_leaves(card["params"]), tree_leaves(host["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_train_resume_bitwise_on_card(cuda, tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import tree_leaves

    _, host, batches, step = _train_setup(cuda)
    state = _to(host, cuda)
    batch = _to(batches[0], cuda)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for _ in range(2):
        state, _ = step(state, batch)
    mgr.save(2, state)
    state, _ = step(state, batch)
    restored, at = mgr.restore(state, device=cuda)
    assert at == 2
    restored, _ = step(restored, batch)
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert torch.equal(a, b)


def test_hybrid_train_step_on_card_matches_cpu(cuda):
    """recurrentgemma's smoke config: three steps on the card (the windowed
    K3's, K5's and K6's backward kernels) against the CPU at 1e-5."""
    from repro_torch.train.optimizer import tree_leaves

    _, host, batches, step = _train_setup(cuda, "recurrentgemma-9b")
    card = _to(host, cuda)
    counts = (fa.bwd_cuda_core_launches.value, rn.bwd_launches.value, k6.bwd_launches.value)
    for batch in batches:
        host, hm = step(host, batch)
        card, cm = step(card, _to(batch, cuda))
        torch.testing.assert_close(cm["loss"].cpu(), hm["loss"], rtol=1e-5, atol=1e-5)
    assert fa.bwd_cuda_core_launches.value == counts[0] + 3  # one attention layer a step
    assert rn.bwd_launches.value > counts[1]
    assert k6.bwd_launches.value == counts[2] + 3 * 4  # four RG-LRU layers a step
    for a, b in zip(tree_leaves(card["params"]), tree_leaves(host["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_hybrid_serving_engine_on_card(cuda):
    """recurrentgemma's smoke config served on the card: every request
    finishes, K3 (windowed, CUDA-core) once per attention layer per wave
    and K6 once per RG-LRU layer per wave, logits within 1e-4 of the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_smoke_config("recurrentgemma-9b")
    host = lm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 20, 9, 40)]
    logits = {}
    for dev in ("cpu", cuda):
        seen = []
        params = lm._tree_map(lambda t: t.to(dev), host)
        engine = ServingEngine(cfg, params, max_batch=2, device=dev,
                               on_logits=lambda stage, x: seen.append(x.cpu()))
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid, p, max_tokens=4))
        counts = (fa.cuda_core_launches.value, k6.launches.value)
        done = engine.run()
        assert len(done) == 4 and all(r.done and 1 <= len(r.output_tokens) <= 4 for r in done)
        logits[str(dev)] = seen
    assert fa.cuda_core_launches.value == counts[0] + 2  # 1 superblock x 2 waves
    assert k6.launches.value == counts[1] + 2 * 4  # 4 RG-LRU layers x 2 waves
    assert len(logits["cuda"]) == len(logits["cpu"])
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# (b, hq, hkv, s, d, window): recurrentgemma's heads (16 on one KV head, d
# = 256) with the band inside a tile, on a tile edge and longer than S,
# head dim 256 without a window, a windowed shape at head dim 128
WINDOW_GRID = [
    (1, 16, 1, 200, 256, 64),
    (2, 16, 1, 300, 256, 128),
    (1, 16, 1, 130, 256, 500),
    (1, 16, 1, 96, 256, None),
    (2, 8, 2, 257, 128, 37),
    # recurrentgemma's sequence blocks over two model positions: position 1's
    # 2048 queries from key 1 (the window cuts it), prefill blocks of 1020
    (1, 16, 1, 4095, 256, 2048),
    (2, 16, 1, 1020, 256, 2048),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window", WINDOW_GRID)
def test_k3_window_and_head_dim_256_match_plain(cuda, b, hq, hkv, s, d, window, dtype):
    q, k, v = _attn_inputs(b, hq, hkv, s, d, dtype, cuda, seed=s + d + (window or 0))
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda).to(dtype)
    route = fa.route(dtype, d, window=window)
    assert route == ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    counter, bwd_counter = fa.route_launches[route], fa.bwd_route_launches[route]
    before, before_bwd = counter.value, bwd_counter.value
    lse = torch.empty((b * hq, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, True, lse=lse, window=window)
    assert torch.equal(out, fa.flash_attention(q, k, v, True, window=window))
    assert counter.value == before + 2
    tol = K3_TOL[dtype]
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, True, window).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, True, window),
                               rtol=1e-5, atol=1e-5)
    if window is not None and window >= s and d == 256:  # causal attention, bitwise
        assert torch.equal(out, fa.flash_attention(q, k, v, True))
    assert fa.bwd_route(q, k, v, out, do, window) == route
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    assert bwd_counter.value == before_bwd + 1
    want = flash_attention_bwd_ref(q, k, v, out, do, True, window)
    btol = K3_BWD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=btol, atol=btol)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_k3_window_at_head_dim_256_on_unaligned_bf16_takes_the_cuda_core_route(cuda):
    """bf16 at head dim 256 with a window on a view off 16 bytes: the
    CUDA-core kernels, forward and backward, at the same bars."""
    b, hq, hkv, s, d, window = 1, 16, 1, 200, 256, 64
    q, k, v = _attn_inputs(b, hq, hkv, s, d, torch.bfloat16, cuda, seed=11)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    qu = buf[1:q.numel() + 1].view(q.shape)  # 2 bytes past a 16-byte boundary
    qu.copy_(q)
    assert fa.route(torch.bfloat16, d, aligned=qu.data_ptr() % 16 == 0,
                    window=window) == "cuda_core"
    before, before_bwd = fa.cuda_core_launches.value, fa.bwd_cuda_core_launches.value
    lse = torch.empty((b * hq, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(qu, k, v, True, lse=lse, window=window)
    assert fa.cuda_core_launches.value == before + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, True, window).float(),
                               rtol=5e-2, atol=5e-2)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                     device=cuda).to(torch.bfloat16)
    assert fa.bwd_route(qu, k, v, out, do, window) == "cuda_core"
    got = fa.flash_attention_bwd(qu, k, v, out, lse, do, True, window)
    assert fa.bwd_cuda_core_launches.value == before_bwd + 1
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, out, do, True, window)):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)


# (b, s, window) at recurrentgemma's heads (16 on one KV head of 256) on the
# tensor cores: ragged S, the band inside a tile (37), on a tile edge (64,
# 128), longer than S (300, 4096), a longer run of tiles through the ring
TC_BAND_GRID = [
    (1, 200, 37), (1, 257, 64), (2, 257, 128), (1, 200, 300), (1, 257, 4096),
    (1, 1100, 512), (2, 70, 37),
]


@pytest.mark.parametrize("b,s,window", TC_BAND_GRID)
def test_k3_tensor_core_band_at_head_dim_256(cuda, b, s, window):
    """The tensor-core route at head dim 256 with a window, group 16 on one
    KV head: forward within 5e-2 and lse within 1e-5 of the plain version,
    the output with lse bitwise the output without it, a window of S or
    more bitwise no window; the backward (dQ, then the dK/dV partials of
    each q head, then their sum) within 2e-2 of the f64 plain backward and
    bitwise the same over two runs."""
    hq, hkv, d = 16, 1, 256
    q, k, v = _attn_inputs(b, hq, hkv, s, d, torch.bfloat16, cuda, seed=s + window)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(s),
                     device=cuda).to(torch.bfloat16)
    assert fa.route(torch.bfloat16, d, window=window) == "tensor_core"
    before, before_bwd = fa.tensor_core_launches.value, fa.bwd_tensor_core_launches.value
    lse = torch.empty((b * hq, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, True, lse=lse, window=window)
    assert torch.equal(out, fa.flash_attention(q, k, v, True, window=window)), \
        "lse changed the output"
    assert fa.tensor_core_launches.value == before + 2
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, True, window).float(),
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, True, window),
                               rtol=1e-5, atol=1e-5)
    if window >= s:  # causal attention, bit for bit
        assert torch.equal(out, fa.flash_attention(q, k, v, True))
    assert fa.bwd_route(q, k, v, out, do, window) == "tensor_core"
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    assert fa.bwd_tensor_core_launches.value == before_bwd + 1
    want = flash_attention_bwd_ref(q, k, v, out, do, True, window)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), "K3 bwd is not bitwise repeatable"
    if window >= s:
        nowin = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
        assert all(torch.equal(a, g) for a, g in zip(nowin, got)), "window >= S changed the bits"


@pytest.mark.parametrize("d,hq,hkv", [(256, 16, 1), (128, 8, 2)])
def test_k3_tensor_core_band_without_causality(cuda, d, hq, hkv):
    """A window with causal=False on the tensor cores (every key up to
    window - 1 behind the query and every key after it), forward and
    backward, at the bf16 bars."""
    s, window = 190, 70
    q, k, v = _attn_inputs(1, hq, hkv, s, d, torch.bfloat16, cuda, seed=d)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(d),
                     device=cuda).to(torch.bfloat16)
    lse = torch.empty((hq, s), dtype=torch.float32, device=cuda)
    before, before_bwd = fa.tensor_core_launches.value, fa.bwd_tensor_core_launches.value
    out = fa.flash_attention(q, k, v, False, lse=lse, window=window)
    assert fa.tensor_core_launches.value == before + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, False, window).float(),
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, False, window),
                               rtol=1e-5, atol=1e-5)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, False, window)
    assert fa.bwd_tensor_core_launches.value == before_bwd + 1
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, out, do, False, window)):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2)


def _scan_inputs(b, s, r, device, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(b, s, r, generator=g) * 0.95 + 0.04
    w, dh = torch.randn(b, s, r, generator=g), torch.randn(b, s, r, generator=g)
    h0 = torch.randn(b, r, generator=g)
    return [t.to(device) for t in (a, w, h0, dh)]


# (b, s, r): recurrentgemma's d_rnn, a ragged R (no whole warp), S shorter
# than one chunk, one step; S one short of a chunk, one chunk, one past it
# (R not a multiple of 4: 4-byte copies), several chunks with a ragged last
# one; recurrentgemma's [train] shape
K6_GRID = [(2, 300, 4096), (1, 37, 100), (3, 5, 33), (2, 1, 64),
           (2, k6.CHUNK - 1, 100), (1, k6.CHUNK, 4096), (3, k6.CHUNK + 1, 33),
           (2, 3 * k6.CHUNK + 5, 4096), (1, 4096, 4096),
           # recurrentgemma's 4096 channels over two model positions
           (1, 4096, 2048), (2, 2040, 2048)]


def _close_to_loop(got: torch.Tensor, loop: torch.Tensor):
    """Within f32 rounding of the sequential loop: 1e-6 of its largest
    magnitude (the chunks join by carries, another order of the same sums)."""
    torch.testing.assert_close(got, loop, rtol=0, atol=1e-6 * float(loop.abs().max()))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,r", K6_GRID)
def test_k6_matches_plain_bitwise(cuda, b, s, r, with_h0):
    a, w, h0, dh = _scan_inputs(b, s, r, cuda, seed=b * s + r)
    h0 = h0 if with_h0 else None
    before, before_bwd = k6.launches.value, k6.bwd_launches.value
    h = k6.rglru_scan(a, w, h0)
    assert k6.launches.value == before + 1
    assert torch.equal(h, rglru_scan_ref(a, w, h0)), "K6 differs from the chunked plain version"
    assert torch.equal(h, k6.rglru_scan(a, w, h0))
    loop = rglru_scan_ref(a, w, h0, chunk=None)
    _close_to_loop(h, loop)
    got = k6.rglru_scan_bwd(a, h, dh, h0)
    assert k6.bwd_launches.value == before_bwd + 1
    want = rglru_scan_bwd_ref(a, h, dh, h0)
    again = k6.rglru_scan_bwd(a, h, dh, h0)
    assert (got[2] is None) == (want[2] is None) == (again[2] is None) == (h0 is None)
    for g, x, y, lo in zip(got, want, again, rglru_scan_bwd_ref(a, h, dh, h0, chunk=None)):
        if g is not None:
            assert torch.equal(g, x) and torch.equal(g, y)
            _close_to_loop(g, lo)


def test_k6_misaligned_views_copy_4_bytes_with_the_same_bits(cuda):
    """Contiguous tensors one float off 16-byte alignment (R % 4 == 0)
    take the 4-byte copies: the same bits as the aligned call."""
    a, w, h0, dh = _scan_inputs(2, 2 * k6.CHUNK + 7, 256, cuda, seed=3)

    def off(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    h = k6.rglru_scan(a, w, h0)
    assert off(a).data_ptr() % 16 != 0
    assert torch.equal(k6.rglru_scan(off(a), off(w), off(h0)), h)
    for g, x in zip(k6.rglru_scan_bwd(off(a), off(h), off(dh), off(h0)),
                    k6.rglru_scan_bwd(a, h, dh, h0)):
        assert torch.equal(g, x)


def test_k6_rejects_views_and_device_mixes(cuda):
    a, w, h0, _ = _scan_inputs(2, 16, 64, cuda, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        k6.rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match="contiguous"):
        k6.rglru_scan(a[:, :, ::2], w[:, :, ::2])
    with pytest.raises(ValueError, match="one CUDA device"):
        k6.rglru_scan(a, w.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        k6.rglru_scan_bwd(a, w, w, h0.cpu())


def test_rglru_scan_under_grad_runs_the_backward_kernel(cuda):
    a, w, h0, dh = _scan_inputs(1, 2 * k6.CHUNK + 40, 96, cuda, seed=1)
    leaves = [t.clone().requires_grad_() for t in (a, w, h0)]
    before = k6.bwd_launches.value
    got = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, dh)
    assert k6.bwd_launches.value == before + 1
    h = rglru_scan_ref(a, w, h0)
    for g, x in zip(got, rglru_scan_bwd_ref(a, h, dh, h0)):
        assert torch.equal(g, x)


# ---------------------------------------------------- the sharded train step


def _mesh_train_case(cuda):
    """qwen2-7b's heads (28/4 of 128, width 3584) at one layer, a small
    MLP and vocab, bf16; a fixed batch of B=2, S=256; the (2, 2) mesh over
    the card repeated."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.train.optimizer import AdamWConfig

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=1, d_ff=1024, vocab_size=1024)
    batch = make_global_batch(0, 0, 2, 256, cfg.vocab_size, device=cuda)
    return cfg, AdamWConfig(lr=1e-3), batch, make_mesh((2, 2), ("data", "model"), "cuda:0")


def test_sharded_step_runs_k3_on_each_positions_heads(cuda, monkeypatch):
    """Each model position's K3 runs 14 of the 28 q heads and 2 of the 4
    kv heads, forward and backward, on the tensor cores; the step's loss
    within 2e-2 of the one-device step's."""
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.train.step import init_train_state, loss_and_grads

    cfg, opt_cfg, batch, mesh = _mesh_train_case(cuda)
    shapes = set()
    for name in ("flash_attention", "flash_attention_bwd"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda q, k, *a, _real=real, _name=name, **kw: shapes.add(
            (_name, *q.shape[:2], k.shape[1])) or _real(q, k, *a, **kw))
    state = init_train_state(cfg, opt_cfg, seed=0, device=cuda)
    want, _ = loss_and_grads(state["params"], cfg, batch)
    shapes.clear()
    before = (fa.tensor_core_launches.value, fa.bwd_tensor_core_launches.value)
    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    _, m = step(shard_train_state(state, mesh), batch)
    assert shapes == {("flash_attention", 1, 14, 2), ("flash_attention_bwd", 1, 14, 2)}
    # 2 data shards x 2 model positions, the forward twice under remat
    assert fa.tensor_core_launches.value - before[0] == 8
    assert fa.bwd_tensor_core_launches.value - before[1] == 4
    assert abs(float(m["loss"]) - float(want)) <= 2e-2 * abs(float(want))


def test_sharded_optimizer_is_adamw_update_bitwise(cuda):
    """The one-device gradients, sliced to the (2, 2) placements, and the
    one-device clip scale: every block of params, m and v after the
    sharded update equals adamw_update's result bitwise."""
    from repro_torch.distributed.sharding import ShardedTensor, tree_map, tree_paths
    from repro_torch.distributed.spmd import (make_sharded_train_step, shard_train_state,
                                              state_shardings)
    from repro_torch.train.optimizer import adamw_update, clip_scale, global_norm
    from repro_torch.train.step import init_train_state, loss_and_grads

    cfg, opt_cfg, batch, mesh = _mesh_train_case(cuda)
    state = init_train_state(cfg, opt_cfg, seed=0, device=cuda)
    _, grads = loss_and_grads(state["params"], cfg, batch)
    sharded = shard_train_state(state, mesh)
    given = tree_map(lambda g, pl: ShardedTensor(pl, tuple(g.shape), [
        g[pl.block(tuple(g.shape), p)] for p in range(mesh.size)]),
        grads, state_shardings(mesh, state)["params"])
    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    step.apply(sharded, given, scale=clip_scale(opt_cfg, global_norm(grads)))
    adamw_update(state["params"], grads, state["opt"], opt_cfg)
    for part in ("params", "m", "v"):
        got = sharded[part] if part == "params" else sharded["opt"][part]
        want = state[part] if part == "params" else state["opt"][part]
        for (path, st), (_, t) in zip(tree_paths(got), tree_paths(want)):
            for p, block in enumerate(st.blocks):
                assert torch.equal(block, t[st.placement.block(st.shape, p)]), (part, path, p)


@pytest.mark.parametrize("check", ["compression_check", "pipeline_check", "elastic_check"])
def test_distributed_checks_pass_on_the_card(cuda, check, capsys, tmp_path):
    import importlib

    args = {"compression_check": ["--devices", "4"],
            "pipeline_check": ["--devices", "4", "--stages", "4"],
            "elastic_check": ["--devices", "8", "--ckpt", str(tmp_path)]}[check]
    importlib.import_module(f"repro_torch.launch.{check}").main(args)
    assert capsys.readouterr().out.splitlines()[-1] == "OK"


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b", "mamba2-2.7b", "deepseek-moe-16b",
                                  "recurrentgemma-9b"])
def test_train_step_counted_on_the_card_equals_its_meta_count(cuda, arch):
    """A smoke config's train step counted live on the card by the
    dry-run's op counter (after one step to warm): FLOPs, bytes, kernel
    calls and copy bytes equal to the same step's count on ``meta``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch import dryrun
    from repro_torch.perf import hlo_cost
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = make_global_batch(0, 0, 2, 32, cfg.vocab_size, device=cuda)
    step = make_train_step(cfg, opt_cfg)
    state, _ = step(init_train_state(cfg, opt_cfg, seed=0, device=cuda), batch)
    live = hlo_cost.analyze(hlo_cost.trace_ops(step, state, batch)[1])
    meta = hlo_cost.analyze(dryrun.count_train_step(
        cfg, opt_cfg, {k: torch.empty_like(v, device="meta") for k, v in batch.items()}))
    for key in ("flops", "bytes", "transcendentals", "kernels", "collective_bytes"):
        assert live[key] == meta[key], (key, live[key], meta[key])
    assert live["flops"] > 0 and live["kernels"]["rms_norm_bwd"] > 0


def test_sharded_step_counted_on_the_card_equals_its_plan(cuda):
    """The (2, 2) sharded step over ``cuda:0`` repeated, counted live,
    against the planner's count on ``meta`` (one shard and one position
    per signature): the same FLOPs, bytes and copy bytes by kind."""
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.launch import dryrun
    from repro_torch.perf import hlo_cost
    from repro_torch.train.step import init_train_state

    cfg, opt_cfg, batch, mesh = _mesh_train_case(cuda)
    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    state, _ = step(shard_train_state(init_train_state(cfg, opt_cfg, seed=0, device=cuda), mesh),
                    batch)
    live = hlo_cost.analyze(hlo_cost.trace_ops(step, state, batch)[1])
    plan = hlo_cost.analyze(dryrun.count_train_step(
        cfg, opt_cfg, {k: torch.empty_like(v, device="meta") for k, v in batch.items()}, mesh))
    for key in ("flops", "bytes", "collective_bytes", "collectives", "collective_counts",
                "kernels"):
        assert live[key] == plan[key], (key, live[key], plan[key])
    assert live["collective_bytes"] > 0


# ---------------------------------------------------- the sharded serving step


def _mesh_serve_case(cuda, shape):
    """qwen2-7b's smoke config in bf16, a prompt of B=4, S=24 and the
    parameters on the card; ``shape``'s mesh over ``cuda:0`` repeated."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), dtype_name="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen, device=cuda,
                           dtype=torch.int32)
    mesh = make_mesh(shape, ("data", "model"), "cuda:0")
    return cfg, lm.init_params(cfg, seed=0, device=cuda), {"tokens": prompt}, mesh


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def test_sharded_serving_on_the_card_matches_one_device(cuda):
    """Prefill and 12 decode steps on (1, 2) over ``cuda:0`` repeated,
    from a cache of 32 slots filled to 24 (model position 1's block of 16
    holds slots 16-31: its keys are written by the prefill's hand-off and
    by every decode step), against the one-device steps at 2e-2; K3 and
    K5 launched."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.distributed.spmd import (make_sharded_serve_prefill,
                                              make_sharded_serve_step, shard_cache)
    from repro_torch.models import lm
    from repro_torch.train.step import make_serve_prefill, make_serve_step

    cfg, params, batch, mesh = _mesh_serve_case(cuda, (1, 2))
    want, prefilled = make_serve_prefill(cfg)(params, batch)
    one = lm.init_cache(cfg, 4, 32, cuda)
    one["k"][:, :, :, :24], one["v"][:, :, :, :24] = prefilled["k"], prefilled["v"]
    one["length"] = 24
    sharded = shard_cache(one, mesh)
    before = (fa.launches.value, rn.launches.value)
    params_mesh = shard_tree(params, param_shardings(mesh, params))
    got, cache = make_sharded_serve_prefill(cfg, mesh)(params_mesh, batch)
    assert _rel(got, want) <= 2e-2
    assert fa.launches.value - before[0] == cfg.num_layers * 2
    decode, decode1 = make_sharded_serve_step(cfg, mesh), make_serve_step(cfg)
    tok = want.argmax(-1, keepdim=True).int()
    for _ in range(8):
        want, one = decode1(params, one, {"tokens": tok})
        got, sharded = decode(params_mesh, sharded, {"tokens": tok})
        assert torch.isfinite(got).all() and _rel(got, want) <= 2e-2
        tok = want.argmax(-1, keepdim=True).int()
    for name in ("k", "v"):
        st = sharded[name]
        for p, block in enumerate(st.blocks):
            assert _rel(block, one[name][st.placement.block(st.shape, p)]) <= 2e-2, (name, p)
    assert rn.launches.value - before[1] > 0


def test_sharded_serving_counted_on_the_card_equals_its_plan(cuda):
    """The (2, 2) prefill and decode step over ``cuda:0`` repeated,
    counted live, against the planner's count on ``meta`` (one data shard
    per row count): the same FLOPs, bytes, kernel calls and copy bytes by
    kind."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.distributed.spmd import ShardedServeStep, shard_cache
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.perf import hlo_cost

    cfg, params, batch, mesh = _mesh_serve_case(cuda, (2, 2))
    step = ShardedServeStep(cfg, mesh)
    params = shard_tree(params, param_shardings(mesh, params))
    meta = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    one = lm.init_cache(cfg, 4, 32, cuda)
    one["length"] = 31
    first = {"tokens": batch["tokens"][:, :1]}
    warm, cache = (shard_cache(one, mesh) for _ in range(2))
    step.prefill(params, batch)
    step.decode(params, warm, first)
    for kind, fn, args, meta_batch in (("prefill", step.prefill, (params, batch), meta),
                                       ("decode", step.decode, (params, cache, first),
                                        {"tokens": meta["tokens"][:, :1]})):
        live = hlo_cost.analyze(hlo_cost.trace_ops(fn, *args)[1])
        plan = hlo_cost.analyze(dryrun.count_serve_step(cfg, kind, meta_batch, mesh, 32))
        for key in ("flops", "bytes", "collective_bytes", "collectives", "collective_counts",
                    "kernels"):
            assert live[key] == plan[key], (kind, key, live[key], plan[key])
        assert live["collective_bytes"] > 0


def test_k3_bwd_runs_on_meta_are_the_launchers(cuda):
    """The ``meta`` route sizes the CUDA-core backward's partials by
    ``_bwd_runs``, the Python form of the launcher's ``bwd::max_q_runs``:
    equal on every length, window and causality."""
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    for s in (1, 63, 64, 65, 200, 512, 1024, 2048, 2304, 4096):
        for win in (0, 1, 63, 64, 65, 512, 2048):
            for causal in (0, 1):
                assert fa._bwd_runs(s, win, causal) == lib.atlas_flash_attention_bwd_runs(
                    s, win, causal), (s, win, causal)


@pytest.mark.parametrize("n,d", [(4080, 4096), (2040, 4096), (1024, 2560), (2, 2560), (1, 4096),
                                 (4096, 2048), (2048, 2048), (2016, 2048), (1008, 2048), (4, 2048),
                                 (2, 2048), (1008, 7168), (2, 7168)])
def test_k5_at_a_data_shards_rows_matches_plain(cuda, n, d):
    """The split steps' row counts (a data shard's prefill and decode rows
    at recurrentgemma's 4096 and mamba's 2560, its training and serving
    rows at deepseek-moe's 2048 and arctic's 7168, bf16): forward and
    backward resident, each at its plain version's bar."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    scale = (0.1 * torch.randn((d,), generator=gen, device=cuda)).to(dtype)
    dy = torch.randn((n, d), generator=gen, device=cuda).to(dtype)
    before, before_bwd = rn.resident_launches.value, rn.bwd_resident_launches.value
    y = rn.rms_norm(x, scale)
    dx, ds = rn.rms_norm_bwd(x, scale, dy)
    assert rn.resident_launches.value == before + 1
    assert rn.bwd_resident_launches.value == before_bwd + 1
    tol = K5_TOL[dtype]
    torch.testing.assert_close(y.float(), rms_norm_ref(x, scale).float(), rtol=tol, atol=tol)
    want = rms_norm_bwd_ref(x, scale, dy)
    torch.testing.assert_close(dx.float(), want[0].float(), rtol=tol, atol=tol)
    assert float((ds.float() - want[1].float()).abs().max()) <= tol * float(
        want[1].float().abs().max())


def _split_case(cuda, arch):
    """``arch``'s smoke config in bf16 on the (1, 2) mesh over ``cuda:0``
    repeated."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), dtype_name="bfloat16")
    return cfg, make_mesh((1, 2), ("data", "model"), "cuda:0")


@pytest.mark.parametrize("arch,mixer", [("mamba2-2.7b", "heads"), ("recurrentgemma-9b", "channels")])
def test_split_recurrent_train_step_on_the_card_matches_one_device(cuda, arch, mixer):
    """The ssm and hybrid families' train step split over ``model`` on
    (1, 2): step 1's loss and gradients within 2e-2 of the one-device
    step's, its K4 or K6 (and the hybrid's K3) launched on the card."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import init_train_state, loss_and_grads

    cfg, mesh = _split_case(cuda, arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = make_global_batch(0, 0, 2, 32, cfg.vocab_size, device=cuda)
    state = init_train_state(cfg, opt_cfg, seed=0, device=cuda)
    want, grads1 = loss_and_grads(state["params"], cfg, batch)
    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    assert step.mixer == mixer
    before = (sc.bwd_launches.value, k6.bwd_launches.value, fa.bwd_launches.value)
    loss, grads = step.loss_and_grads(shard_train_state(state, mesh)["params"], batch)
    assert abs(float(loss) - float(want)) <= 2e-2 * abs(float(want))
    for (path, g), ref in zip(tree_paths(grads), tree_leaves(grads1)):
        assert _rel(g.full(), ref.float()) <= 2e-2, path
    if arch.startswith("mamba"):  # one backward a layer and position
        assert sc.bwd_launches.value - before[0] == cfg.num_layers * 2
    else:
        assert k6.bwd_launches.value - before[1] == (cfg.num_layers - cfg.num_layers // 3) * 2
        assert fa.bwd_launches.value - before[2] == cfg.num_layers // 3 * 2


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_split_recurrent_serving_on_the_card_matches_one_device(cuda, arch):
    """Prefill and 8 decode steps on (1, 2) from a prompt of 12 in a cache
    of 32 (recurrentgemma's ring of 16 slots wraps at 16), against the
    one-device steps at 2e-2, the recurrent states and the ring's blocks
    too."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree, tree_paths
    from repro_torch.distributed.spmd import ShardedServeStep, shard_cache
    from repro_torch.models import lm
    from repro_torch.train.step import make_serve_prefill, make_serve_step

    cfg, mesh = _split_case(cuda, arch)
    params = lm.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16 if arch.startswith("mamba")
                                                         else 12),
                                     generator=gen, device=cuda, dtype=torch.int32)}
    s = batch["tokens"].shape[1]
    want, prefilled = make_serve_prefill(cfg)(params, batch)
    step = ShardedServeStep(cfg, mesh)
    sharded = shard_tree(params, param_shardings(mesh, params))
    got, _ = step.prefill(sharded, batch)
    assert _rel(got, want) <= 2e-2
    one = lm.init_cache(cfg, 4, 32, cuda)
    if "k" in one:
        one["k"][:, :, :, :s], one["v"][:, :, :, :s] = prefilled["k"], prefilled["v"]
    for name in ("layers", "r1", "r2", "tail"):
        if name in one:
            one[name] = {k: v.clone() for k, v in prefilled[name].items()}
    one["length"] = s
    cache = shard_cache(one, mesh)
    decode1 = make_serve_step(cfg)
    tok = want.argmax(-1, keepdim=True).int()
    for _ in range(8):
        want, one = decode1(params, one, {"tokens": tok})
        got, cache = step.decode(sharded, cache, {"tokens": tok})
        assert torch.isfinite(got).all() and _rel(got, want) <= 2e-2
        tok = want.argmax(-1, keepdim=True).int()
    whole = dict(tree_paths({k: v for k, v in one.items() if k != "length"}))
    for path, st in tree_paths({k: v for k, v in cache.items() if k != "length"}):
        for p, block in enumerate(st.blocks):
            ref = whole[path][st.placement.block(st.shape, p)]
            assert _rel(block, ref) <= 2e-2, (path, p)


# ------------------------------------------------- the moe family's experts split

MOE_LAYER_CASES = [("deepseek-moe-16b", torch.bfloat16, 64), ("deepseek-moe-16b", torch.float32, 64),
                   ("arctic-480b", torch.bfloat16, 8)]
MOE_LAYER_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _layer_shares(step, layer: dict) -> list[dict]:
    """Each model position's share of one layer's whole leaves, sliced as
    ``step._share`` splits them (attention by heads)."""
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.distributed.spmd import _put

    out: list[dict] = [{} for _ in range(step.tp)]
    for path, t in tree_paths(layer):
        ms, dim = step._share(path, "heads", step.mlp)
        for m in ms:
            _put(out[m], path, t[step._region(tuple(t.shape), dim, m)])
    return out


@pytest.mark.parametrize("arch,dtype,experts", MOE_LAYER_CASES)
def test_split_moe_layer_on_the_card_matches_one_device(cuda, monkeypatch, arch, dtype, experts):
    """One moe block's FFN at the model's published widths (arctic's
    d_model 7168 and d_ff 4864 with 8 of its 128 experts, to fit a test),
    split over (1, 2) on the card repeated, each position on half the
    experts, against one device on the same rows: the routing bitwise, the
    output and the gradients of the rows and of every leaf (router,
    experts, shared experts or dense residual) within 2e-2 in bf16 and
    1e-5 in f32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import tree_map, tree_paths
    from repro_torch.models import lm
    from repro_torch.models import moe as tmoe
    from repro_torch.train.optimizer import AdamWConfig

    base = get_config(arch)
    cfg = dataclasses.replace(base, num_layers=base.first_k_dense + 1, num_experts=experts,
                              vocab_size=1024, dtype_name=str(dtype)[6:])
    lp = lm.layer(lm.init_params(cfg, seed=0, device=cuda)["moe_blocks"], 0)
    leaves = tree_map(lambda t: t.detach().requires_grad_(),
                      {k: v for k, v in lp.items() if k in ("moe", "shared", "residual")})
    routes = []
    real = tmoe.moe_route

    def route(*args, **kw):
        out = real(*args, **kw)
        routes.append([t.detach().clone() for t in out])
        return out

    monkeypatch.setattr(tmoe, "moe_route", route)
    monkeypatch.setattr(spmd, "moe_route", route)
    step = spmd.ShardedTrainStep(cfg, AdamWConfig(), make_mesh((1, 2), ("data", "model"), "cuda:0"))
    assert step.experts == "experts" and step.mlp == "columns"
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn((2, 256, cfg.d_model), generator=gen, device=cuda).to(dtype)
    dy = torch.randn(h.shape, generator=gen, device=cuda).to(dtype)
    devices = [step.devices[int(p)] for p in step.rows[0]]
    outs = []
    for fn in (lambda x: lm._moe_ffn(leaves, cfg, x),
               lambda x: step._moe(_layer_shares(step, leaves), x, devices, step.mlp)):
        x = h.clone().requires_grad_()
        y = fn(x)
        outs.append((y.detach(), torch.autograd.grad(y, [x] + [t for _, t in tree_paths(leaves)],
                                                     dy)))
    one, split = routes
    assert all(torch.equal(a, b) for a, b in zip(one, split))
    tol = MOE_LAYER_TOL[dtype]
    assert _rel(outs[1][0], outs[0][0]) <= tol
    for name, a, b in zip(["h"] + [p for p, _ in tree_paths(leaves)], outs[0][1], outs[1][1]):
        assert torch.isfinite(b.float()).all(), name
        if float(a.float().norm()):
            assert _rel(b, a) <= tol, (name, _rel(b, a))


@pytest.mark.parametrize("b,hq,hkv,s", [(4, 8, 8, 1024), (2, 8, 8, 1024), (4, 8, 8, 504),
                                        (2, 8, 8, 504), (4, 16, 16, 504), (2, 28, 4, 504),
                                        (2, 56, 8, 504)])
def test_k3_at_the_moe_split_steps_heads_matches_plain(cuda, b, hq, hkv, s):
    """K3 at the moe split steps' shapes (deepseek-moe's 16/16 heads of
    128 and a model position's 8/8, arctic's 56/8 and 28/4; S=1024 trained,
    504 served), bf16, on the tensor cores, forward and (at S=1024)
    backward, at its plain version's bar."""
    dtype, d = torch.bfloat16, 128
    q, k, v = _attn_inputs(b, hq, hkv, s, d, dtype, cuda, seed=s + hq + b)
    before = fa.tensor_core_launches.value
    out = fa.flash_attention(q, k, v, True)
    assert fa.tensor_core_launches.value == before + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, True).float(),
                               rtol=K3_TOL[dtype], atol=K3_TOL[dtype])
    if s != 1024:
        return
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda).to(dtype)
    lse = torch.empty((b * hq, s), dtype=torch.float32, device=cuda)
    out = fa.flash_attention(q, k, v, True, lse=lse)
    before = fa.bwd_tensor_core_launches.value
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert fa.bwd_tensor_core_launches.value == before + 1
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, out, do, True)):
        torch.testing.assert_close(g.float(), w.float(), rtol=K3_BWD_TOL[dtype],
                                   atol=K3_BWD_TOL[dtype])


def _moe_split_case(cuda, arch):
    """``arch``'s smoke config (f32) on the (1, 2) mesh over ``cuda:0``
    repeated: its experts split, so the step is held to one device at
    1e-4 (f32, the routing the same)."""
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(arch), make_mesh((1, 2), ("data", "model"), "cuda:0")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "arctic-480b"])
def test_split_moe_train_step_on_the_card_matches_one_device(cuda, arch):
    """The moe family's train step with its experts split over (1, 2):
    step 1's loss and gradients within 1e-4 of the one-device step's (f32
    smoke config), its K3 forward and backward launched once a layer and
    position (twice forward under remat)."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.step import init_train_state, loss_and_grads

    cfg, mesh = _moe_split_case(cuda, arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = make_global_batch(0, 0, 2, 32, cfg.vocab_size, device=cuda)
    state = init_train_state(cfg, opt_cfg, seed=0, device=cuda)
    want, grads1 = loss_and_grads(state["params"], cfg, batch)
    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    assert step.experts == "experts"
    before = (fa.launches.value, fa.bwd_launches.value)
    loss, grads = step.loss_and_grads(shard_train_state(state, mesh)["params"], batch)
    assert abs(float(loss) - float(want)) <= 1e-4 * abs(float(want))
    for (path, g), ref in zip(tree_paths(grads), tree_leaves(grads1)):
        assert _rel(g.full(), ref) <= 1e-4, path
    assert fa.launches.value - before[0] == 2 * cfg.num_layers * 2
    assert fa.bwd_launches.value - before[1] == cfg.num_layers * 2


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "arctic-480b"])
def test_split_moe_serving_on_the_card_matches_one_device(cuda, arch):
    """Prefill and 8 decode steps on (1, 2) from a prompt of 12 in a cache
    of 32, the experts split: logits and every cache block within 1e-4 of
    the one-device steps (f32 smoke config)."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.distributed.spmd import ShardedServeStep, shard_cache
    from repro_torch.models import lm
    from repro_torch.train.step import make_serve_prefill, make_serve_step

    cfg, mesh = _moe_split_case(cuda, arch)
    params = lm.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 12), generator=gen, device=cuda,
                                     dtype=torch.int32)}
    want, prefilled = make_serve_prefill(cfg)(params, batch)
    step = ShardedServeStep(cfg, mesh)
    assert step.experts == "experts"
    sharded = shard_tree(params, param_shardings(mesh, params))
    got, _ = step.prefill(sharded, batch)
    assert _rel(got, want) <= 1e-4
    one = lm.init_cache(cfg, 4, 32, cuda)
    one["k"][:, :, :, :12], one["v"][:, :, :, :12] = prefilled["k"], prefilled["v"]
    one["length"] = 12
    cache = shard_cache(one, mesh)
    decode1 = make_serve_step(cfg)
    tok = want.argmax(-1, keepdim=True).int()
    for _ in range(8):
        want, one = decode1(params, one, {"tokens": tok})
        got, cache = step.decode(sharded, cache, {"tokens": tok})
        assert torch.isfinite(got).all() and _rel(got, want) <= 1e-4
        tok = want.argmax(-1, keepdim=True).int()
    for name in ("k", "v"):
        for p, block in enumerate(cache[name].blocks):
            assert _rel(block, one[name][cache[name].placement.block(cache[name].shape, p)]) <= 1e-4
