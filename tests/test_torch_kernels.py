"""Port kernels K1 (edge_block_spmm) and K2 (fused_graduate) against the
JAX package.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the Pallas kernel in interpret mode and the JAX oracles on the
same numpy inputs.  The kernels themselves are tested on the card in
tests/test_torch_gpu.py.

Tolerances: K1 rtol=1e-4/atol=1e-5, the backend grid's bar
(tests/test_backend_pipeline.py) — summation order differs between a
sequential segment walk, ``index_add_`` and the one-hot GEMMs.  K2 1e-5
in f32 and 2e-2 in bf16, the bar of tests/test_kernels.py.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.edge_block_spmm import edge_block_spmm as jax_spmm
from repro.kernels.fused_graduate import fused_graduate as jax_graduate
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.kernels import edge_block_spmm as ebs
from repro_torch.kernels import fused_graduate as fg

from tests.test_torch_gpu import K2_TOL, SPMM_GRID, _spmm_inputs
from tests.test_torch_gpu import _sorted as _sorted_on

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _sorted(feats, src, dst, w):
    return _sorted_on(feats, src, dst, w, "cpu")


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("n,d,m,num_dst", SPMM_GRID)
def test_spmm_plain_matches_pallas_and_jax_ref(n, d, m, num_dst):
    feats, src, dst, w = _spmm_inputs(n, d, m, num_dst, seed=n * 7 + m + d)
    got = ops.broadcast_aggregate(
        torch.from_numpy(feats), torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(w), num_dst,
    )
    assert got.dtype == torch.float32 and got.shape == (num_dst, d)
    pallas = np.asarray(jax_spmm(
        jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        num_dst, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-5)
    if m:
        oracle = np.asarray(jref.edge_block_spmm_ref(
            jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(w), num_dst,
        ))
        np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,d,m,num_dst", SPMM_GRID)
def test_segment_reduce_sorted_matches_unsorted(n, d, m, num_dst):
    """The engine's entry (edges grouped by destination) computes the same
    rows as the general entry."""
    feats, src, dst, w = _spmm_inputs(n, d, m, num_dst, seed=m + 1)
    got = ebs.segment_reduce_sorted(*_sorted(feats, src, dst, w))
    want = ebs.edge_block_spmm(
        torch.from_numpy(feats), torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(w), num_dst,
    )[: got.shape[0]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_spmm_sentinel_edges_add_nothing():
    """-1 padding edges (the TPU kernel's sentinel) contribute zero, in
    the port as in the Pallas kernel."""
    feats, src, dst, w = _spmm_inputs(20, 8, 50, 10, seed=5)
    src[::7] = -1
    dst[::5] = -1
    got = ops.broadcast_aggregate(
        torch.from_numpy(feats), torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(w), 10,
    )
    pallas = np.asarray(jax_spmm(
        jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        10, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-5)


def test_spmm_bf16_feats_accumulate_in_f32():
    feats, src, dst, w = _spmm_inputs(40, 16, 200, 30, seed=9)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    got = ebs.segment_reduce_sorted(fb, *_sorted(feats, src, dst, w)[1:])
    assert got.dtype == torch.float32
    want = ebs.segment_reduce_sorted(fb.float(), *_sorted(feats, src, dst, w)[1:])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_segment_reduce_empty_segments_are_zero_rows():
    feats = torch.ones(3, 4)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 4.0])
    offsets = torch.tensor([0, 0, 2, 2, 3], dtype=torch.int32)
    got = ebs.segment_reduce_sorted(feats, src, w, offsets)
    torch.testing.assert_close(
        got, torch.tensor([[0.0] * 4, [3.0] * 4, [0.0] * 4, [4.0] * 4])
    )


def test_segment_reduce_rejects_bad_inputs():
    feats = torch.zeros(4, 2)
    src = torch.zeros(3, dtype=torch.int32)
    w = torch.zeros(3)
    off = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ebs.segment_reduce_sorted(feats, src.long(), w, off)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ebs.segment_reduce_sorted(feats.double(), src, w, off)
    with pytest.raises(ValueError, match="one length"):
        ebs.segment_reduce_sorted(feats, src, w[:2], off)


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,m", [(64, 48, 40), (37, 130, 17)])
def test_graduate_plain_matches_pallas(activation, dtype, n, k, m):
    rng = np.random.default_rng(n + k + m)
    x = rng.normal(size=(n, k)).astype(np.float32)
    w = (rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    got = ops.graduate(xt, wt, bt, activation)
    assert got.dtype == dtype and got.shape == (n, m)
    jd = JNP[dtype]
    pallas = jax_graduate(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd), activation,
        block_n=32, block_k=64, block_m=32, interpret=True,
    )
    tol = K2_TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(pallas, np.float32), rtol=tol, atol=tol
    )


def test_graduate_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 64).reshape(8, 8)
    eye = torch.eye(8)
    got = fg.fused_graduate(x, eye, torch.zeros(8), "gelu")
    oracle = np.asarray(jref.fused_graduate_ref(
        jnp.asarray(x.numpy()), jnp.asarray(eye.numpy()), jnp.zeros(8), "gelu"
    ))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(x)
    assert not torch.allclose(got, erf, rtol=0, atol=1e-6)


def test_graduate_rejects_bad_inputs():
    x, w, b = torch.zeros(4, 3), torch.zeros(3, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="activation"):
        fg.fused_graduate(x, w, b, "tanh")
    with pytest.raises(ValueError, match="shape mismatch"):
        fg.fused_graduate(x, torch.zeros(4, 2), b)
    with pytest.raises(TypeError, match="share"):
        fg.fused_graduate(x, w.to(torch.bfloat16), b)


# ------------------------------------------------------- build, devices


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_missing_nvcc_raises_with_a_hint(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.load("edge_block_spmm")
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_tracks_source_hash():
    _, lib = _build._target("edge_block_spmm")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert set(_build.SIGNATURES) == {
        p.stem for p in _build.CSRC.glob("*.cu")
    }


def test_launch_count_is_thread_safe():
    count = _build.LaunchCount()
    threads = [
        threading.Thread(target=lambda: [count.add() for _ in range(2000)])
        for _ in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert count.value == 16000
    count.reset()
    assert count.value == 0


def test_cpu_paths_never_launch():
    before = (ebs.launches.value, fg.launches.value)
    ops.broadcast_aggregate(
        torch.ones(2, 2), torch.tensor([0, 1]), torch.tensor([1, 0]),
        torch.ones(2), 2,
    )
    ops.graduate(torch.ones(2, 2), torch.ones(2, 2), torch.ones(2))
    assert (ebs.launches.value, fg.launches.value) == before
