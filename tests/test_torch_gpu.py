"""The port's CUDA kernels and its engine on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  Run them on a GPU machine with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed; the CPU tests hold the plain versions against JAX.

Tolerances: K1 rtol=1e-4/atol=1e-5 against its plain version (another
summation order), bitwise against itself; K2 1e-5 in f32 and 2e-2 in
bf16; the engine bitwise against its CPU run on exact-arithmetic graphs.
"""

import numpy as np
import pytest
import torch

from repro_torch import exact
from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.kernels import edge_block_spmm as ebs
from repro_torch.kernels import fused_graduate as fg
from repro_torch.kernels.ref import segment_reduce_sorted_ref
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


def test_k1_rejects_cpu_cuda_mix(cuda):
    feats, src, dst, w = _spmm_inputs(8, 4, 10, 5, seed=0)
    ops = _sorted(feats, src, dst, w, cuda)
    ops[1] = ops[1].cpu()
    with pytest.raises(ValueError, match="one CUDA device"):
        ebs.segment_reduce_sorted(*ops)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m", [(300, 130, 70), (64, 512, 172), (1, 7, 3)])
def test_k2_kernel_matches_plain(cuda, activation, dtype, n, k, m):
    g = torch.Generator().manual_seed(n + k + m)
    x = torch.randn(n, k, generator=g).to(cuda, dtype)
    w = (torch.randn(k, m, generator=g) / k**0.5).to(cuda, dtype)
    b = torch.randn(m, generator=g).to(cuda, dtype)
    before = fg.launches.value
    got = fg.fused_graduate(x, w, b, activation)
    torch.cuda.synchronize()
    assert fg.launches.value == before + 1
    tol = K2_TOL[dtype]
    torch.testing.assert_close(
        got.float(), fg.fused_graduate_ref(x, w, b, activation).float(),
        rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_engine_on_card_equals_cpu_run_exactly(cuda, tmp_path, kind):
    """Exact-arithmetic graph: the CUDA run (K1 + K2, staged pipeline,
    side streams, pinned buffers) gives the CPU run's bits."""
    csr, feats, specs = exact.exact_graph_and_specs(1024, 16, kind=kind)
    out = {}
    for backend in ("cpu", "cuda"):
        store = GraphStore.create(str(tmp_path / backend), csr, feats, order="at")
        cfg = AtlasConfig(backend=backend, chunk_bytes=128 * 16 * 4, hot_slots=200)
        k1, k2 = ebs.launches.value, fg.launches.value
        with AtlasSession(store, config=cfg) as s:
            result = s.infer(specs)
        if backend == "cuda":
            assert ebs.launches.value > k1 and fg.launches.value > k2
        out[backend] = spills_to_dense(result.final.spills, 1024, specs[-1].out_dim)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
