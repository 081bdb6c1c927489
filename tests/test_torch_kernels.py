"""Port kernels K1–K5 against the JAX package: edge_block_spmm,
fused_graduate, flash_attention, ssd_chunk and rms_norm.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the Pallas kernel in interpret mode and the JAX oracles on the
same numpy inputs.  The kernels themselves are tested on the card in
tests/test_torch_gpu.py.

Tolerances: K1 rtol=1e-4/atol=1e-5, the backend grid's bar
(tests/test_backend_pipeline.py) — summation order differs between a
sequential segment walk, ``index_add_`` and the one-hot GEMMs.  K2 1e-5
in f32 and 2e-2 in bf16, the bar of tests/test_kernels.py.  K3 2e-5 in
f32 and 5e-2 in bf16 (the TPU kernel keeps the probabilities in f32, the
JAX oracle rounds them to bf16), K4 2e-4, K5 1e-5 in f32 and 2e-2 in
bf16 — tests/test_kernels.py's bars.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jref_ops
from repro.kernels import ref as jref
from repro.kernels.edge_block_spmm import edge_block_spmm as jax_spmm
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.fused_graduate import fused_graduate as jax_graduate
from repro.kernels.rms_norm import rms_norm_fused as jax_rms_norm_fused
from repro.kernels.ssd_chunk import ssd_scan as jax_ssd_scan
from repro.models import layers as jax_layers
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.kernels import edge_block_spmm as ebs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_graduate as fg
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models import mamba as tmamba

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


# ------------------------------------------------------------------ K3


def _np_attn(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_matches_pallas(hq, hkv, causal):
    q, k, v = _np_attn(2, hq, hkv, 256, 64, seed=hq * 10 + hkv)
    got = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)), causal)
    pallas = jax_flash(*(jnp.asarray(t) for t in (q, k, v)), causal,
                       block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
    oracle = jref.gqa_attention_ref(*(jnp.asarray(t) for t in (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_attention_plain_bf16_matches_pallas():
    q, k, v = _np_attn(1, 4, 2, 128, 128, seed=99)
    got = ops.attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    pallas = jax_flash(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), True,
                       block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_ragged_length(causal):
    """S = 200 is no multiple of any block: the Pallas kernel cannot take
    it, the port's kernel masks the tail; held against the oracle."""
    q, k, v = _np_attn(2, 8, 2, 200, 32, seed=200)
    got = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)), causal)
    oracle = jref.gqa_attention_ref(*(jnp.asarray(t) for t in (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_attention_matches_blockwise_twin():
    """The port's prefill attention against the JAX model's blockwise
    attention (several KV blocks, so the online softmax really carries)."""
    q, k, v = _np_attn(1, 4, 2, 128, 16, seed=7)
    got = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)))
    twin = jax_layers.blockwise_attention(*(jnp.asarray(t) for t in (q, k, v)), block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), rtol=2e-5, atol=2e-5)


# (s, window, block_kv): the band cuts inside a block, on a block edge, and
# a window as long as the sequence (causal attention)
WINDOW_CASES = [(96, 40, 32), (80, 16, 16), (48, 48, 16)]


@pytest.mark.parametrize("s,window,block_kv", WINDOW_CASES)
def test_attention_window_matches_blockwise_twin(s, window, block_kv):
    """recurrentgemma's local attention (head dim 256, 16 query heads on
    one KV head) against the JAX model's ``blockwise_attention(window=)``."""
    q, k, v = _np_attn(1, 16, 1, s, 256, seed=s + window)
    got = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)), True, window)
    twin = jax_layers.blockwise_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                          window=window, block_kv=block_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), rtol=1e-5, atol=1e-5)
    lse = torch.empty((16, s))
    out = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), True, lse=lse,
                             window=window)
    assert torch.equal(out, got)
    causal = ops.attention(*(torch.from_numpy(t) for t in (q, k, v)), True)
    assert torch.equal(got, causal) == (window >= s)


def test_attention_window_mask_is_the_jax_mask():
    from repro_torch.kernels.ref import attention_mask

    pos = jnp.arange(11)
    for causal in (True, False):
        for window in (None, 1, 4, 11, 20):
            want = jax_layers._attn_mask(pos, pos, causal, window)
            got = attention_mask(11, causal, window, "cpu")
            assert (got is None) == (not causal and window is None)
            if got is not None:
                assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ K4


def _np_ssd(bh, s, p, n, seed, rows_bc=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bh, s, p)).astype(np.float32)
    a = rng.uniform(0.7, 1.0, size=(bh, s)).astype(np.float32)
    b = (rng.normal(size=(rows_bc or bh, s, n)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(rows_bc or bh, s, n)) * 0.3).astype(np.float32)
    return x, a, b, c


@pytest.mark.parametrize("s,chunk,p,n", [(128, 32, 16, 32), (256, 64, 64, 128)])
def test_ssd_plain_matches_pallas(s, chunk, p, n):
    x, a, b, c = _np_ssd(3, s, p, n, seed=s)
    got = ops.ssd(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk)
    pallas = jax_ssd_scan(*(jnp.asarray(t) for t in (x, a, b, c)), chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-4, atol=2e-4)
    oracle = jref_ops.ssd_ref(*(jnp.asarray(t) for t in (x, a, b, c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-4, atol=2e-4)


def test_ssd_state_carries_across_chunks():
    x, a, b, c = _np_ssd(1, 128, 8, 16, seed=5)
    full = sc.ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c)), 64)
    halves = [sc.ssd_scan(*(torch.from_numpy(t[:, i:i + 64].copy()) for t in (x, a, b, c)), 64)
              for i in (0, 64)]
    assert not np.allclose(full.numpy(), np.concatenate([h.numpy() for h in halves], axis=1))
    np.testing.assert_allclose(full[:, :64].numpy(), halves[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,chunk,heads", [(64, 16, 1), (96, 32, 3)])
def test_ssd_final_state_matches_the_direct_sum(s, chunk, heads):
    """``return_state``'s state is ``Σ_t (Π_{r>t} a_r) x_t b_tᵀ`` over the
    whole sequence (the JAX prefill's ``_mamba_final_state`` form)."""
    x, a, b, c = _np_ssd(2 * heads, s, 8, 16, seed=s + heads, rows_bc=2)
    y, state = ops.ssd(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk,
                       heads_per_bc=heads, return_state=True)
    np.testing.assert_array_equal(
        y.numpy(), ops.ssd(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk,
                           heads_per_bc=heads).numpy())
    cl = np.cumsum(np.log(a.astype(np.float64)), axis=1)
    wgt = np.exp(cl[:, -1:] - cl)  # [BH, S]
    bseq = b.astype(np.float64)[np.arange(2 * heads) // heads]
    want = np.einsum("hsp,hsn->hpn", x * wgt[..., None], bseq)
    assert state.dtype == torch.float32 and state.shape == (2 * heads, 8, 16)
    np.testing.assert_allclose(state.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ssd_shared_bc_matches_mamba_ssd_chunked():
    """The model's layout: b/c [B,S,N] shared by the H heads of a batch
    row, against the JAX model's own chunked scan."""
    bsz, s, h, p, n = 2, 64, 3, 8, 16
    rng = np.random.default_rng(11)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    a = rng.uniform(0.6, 1.0, size=(bsz, s, h)).astype(np.float32)
    b, c = ((rng.normal(size=(bsz, s, n)) * 0.3).astype(np.float32) for _ in range(2))
    want = jax_mamba.ssd_chunked(*(jnp.asarray(t) for t in (x, a, b, c)), chunk=16)
    got = tmamba.ssd_chunked(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    flat = ops.ssd(
        torch.from_numpy(x).permute(0, 2, 1, 3).reshape(bsz * h, s, p),
        torch.from_numpy(a).permute(0, 2, 1).reshape(bsz * h, s),
        torch.from_numpy(b), torch.from_numpy(c), 16, heads_per_bc=h,
    )
    np.testing.assert_allclose(flat.reshape(bsz, h, s, p).permute(0, 2, 1, 3).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def _split(v: torch.Tensor, lo: bool = True):
    """``v`` as a bf16 hi + lo pair, each widened back to f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, ((v - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(v))


def _ssd_tensor_core_emulated(x, a, b, c, chunk, heads_per_bc, lo=True):
    """The tensor-core route's arithmetic in plain PyTorch: chunk-local
    states from ``w∘X`` split into bf16 hi + lo against bf16 B, an f32
    state pass, the readout against the carried state's hi + lo, and the
    decayed ``C Bᵀ`` as hi + lo against bf16 X; every product of two
    bf16 values accumulated in f32 (as ``wgmma`` does).  ``lo=False``
    drops the lo parts: each f32 operand rounded to bf16 alone."""
    bh, s, p = x.shape
    idx = torch.arange(bh) // heads_per_bc
    xf, bf, cf = x.float(), b.float()[idx], c.float()[idx]
    state = torch.zeros(bh, p, b.shape[-1])
    tril = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xk, bk, ck = (t[:, c0:c0 + chunk] for t in (xf, bf, cf))
        cl = torch.cumsum(torch.log(a[:, c0:c0 + chunk].float()), dim=1)
        shi, slo = _split(state, lo)
        y = torch.exp(cl)[..., None] * (ck @ shi.transpose(1, 2) + ck @ slo.transpose(1, 2))
        diff = (cl[:, :, None] - cl[:, None, :]).masked_fill(~tril, 0.0)
        ghi, glo = _split((ck @ bk.transpose(1, 2)) * torch.exp(diff).masked_fill(~tril, 0.0), lo)
        ys.append(y + ghi @ xk + glo @ xk)
        whi, wlo = _split(torch.exp(cl[:, -1:] - cl)[..., None] * xk, lo)
        state = (state * torch.exp(cl[:, -1])[:, None, None]
                 + whi.transpose(1, 2) @ bk + wlo.transpose(1, 2) @ bk)
    return torch.cat(ys, dim=1).to(x.dtype), state


def test_ssd_hi_lo_split_keeps_the_state_at_f32_accuracy():
    """The tensor-core route feeds f32 operands to bf16 ``wgmma`` as hi + lo
    pairs: emulated, the final state stays within the f32 bar (2e-4) of the
    plain version over three chunks, where bf16 operands alone miss it, and
    y stays within the bf16 bar (2e-2)."""
    bh, s, p, n, heads, chunk = 16, 768, 64, 128, 8, 256  # mamba2-2.7b's P, N, chunk
    x, a, b, c = _np_ssd(bh, s, p, n, seed=3, rows_bc=bh // heads)
    x, b, c = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, b, c))
    a = torch.from_numpy(a)
    assert sc.route(x.dtype, p, n, chunk) == "tensor_core"
    want_y, want_state = sc.ssd_scan(x, a, b, c, chunk, heads_per_bc=heads, return_state=True)
    y, state = _ssd_tensor_core_emulated(x, a, b, c, chunk, heads)
    torch.testing.assert_close(state, want_state, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=2e-2, atol=2e-2)
    _, bf16_state = _ssd_tensor_core_emulated(x, a, b, c, chunk, heads, lo=False)
    assert float((bf16_state - want_state).abs().max()) > 2e-4


def _ssd_bwd_tensor_core_emulated(x, a, b, c, dy, chunk, heads_per_bc, lo=True):
    """The tensor-core backward's arithmetic in plain PyTorch: ``S_in``
    from the forward's chunk-local states (``w∘X`` as hi + lo against bf16
    B) and ``dS`` from their mirror (``e^cl∘dY`` as hi + lo against bf16
    C), each carried in f32 and entered as hi + lo; per chunk the decayed
    ``C Bᵀ`` and ``dY Xᵀ`` as hi + lo against bf16 dY, C and B (the
    transposed tiles for dX and dB, the untransposed for dC); every
    product of two bf16 values accumulated in f32; db and dc summed over
    the heads of each group of ``bwd_head_group`` heads, then over the
    groups.  ``lo=False`` drops the lo parts."""
    bh, s, p = x.shape
    n = b.shape[-1]
    rows = bh // heads_per_bc
    idx = torch.arange(bh) // heads_per_bc
    xf, dyf, bf, cf = x.float(), dy.float(), b.float()[idx], c.float()[idx]
    starts = list(range(0, s, chunk))
    cls = [torch.cumsum(torch.log(a[:, c0:c0 + chunk].float()), dim=1) for c0 in starts]
    local_s, local_d = [], []
    for k, c0 in enumerate(starts):
        sl, cl = slice(c0, c0 + chunk), cls[k]
        whi, wlo = _split(torch.exp(cl[:, -1:] - cl)[..., None] * xf[:, sl], lo)
        local_s.append(whi.transpose(1, 2) @ bf[:, sl] + wlo.transpose(1, 2) @ bf[:, sl])
        ehi, elo = _split(torch.exp(cl)[..., None] * dyf[:, sl], lo)
        local_d.append(ehi.transpose(1, 2) @ cf[:, sl] + elo.transpose(1, 2) @ cf[:, sl])
    zero = torch.zeros(bh, p, n)
    s_in, d_s = [zero], [zero] * len(starts)
    for k in range(len(starts) - 1):
        s_in.append(s_in[-1] * torch.exp(cls[k][:, -1])[:, None, None] + local_s[k])
    for k in range(len(starts) - 1, 0, -1):
        d_s[k - 1] = d_s[k] * torch.exp(cls[k][:, -1])[:, None, None] + local_d[k]
    tril = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    dx, dloga, db, dc = (torch.empty_like(t) for t in (xf, a.float(), bf, cf))
    for k, c0 in enumerate(starts):
        sl, cl = slice(c0, c0 + chunk), cls[k]
        xk, bk, ck, dyk = xf[:, sl], bf[:, sl], cf[:, sl], dyf[:, sl]
        sh, slo = _split(s_in[k], lo)
        dh, dlo = _split(d_s[k], lo)
        lmat = torch.exp((cl[:, :, None] - cl[:, None, :]).masked_fill(~tril, 0.0)).masked_fill(~tril, 0.0)
        g, d = ck @ bk.transpose(1, 2), dyk @ xk.transpose(1, 2)  # rows t, columns s
        lg, ld = lmat * g, lmat * d
        m = lg * d
        e, w = torch.exp(cl), torch.exp(cl[:, -1:] - cl)
        ghi, glo = _split(lg.transpose(1, 2), lo)
        dthi, dtlo = _split(ld.transpose(1, 2), lo)
        dhi, dlo_ = _split(ld, lo)
        bds = bk @ dh.transpose(1, 2) + bk @ dlo.transpose(1, 2)  # B dSᵀ
        xds = xk @ dh + xk @ dlo  # X dS
        dys = dyk @ sh + dyk @ slo  # dY S_in
        dx[:, sl] = w[..., None] * bds + (ghi @ dyk + glo @ dyk)
        db[:, sl] = w[..., None] * xds + (dthi @ ck + dtlo @ ck)
        dc[:, sl] = e[..., None] * dys + (dhi @ bk + dlo_ @ bk)
        wq = w * (bk * xds).sum(-1)
        dcl = (m.sum(2) + e * (ck * dys).sum(-1)) - (m.sum(1) + wq)
        tail = torch.exp(cl[:, -1]) * ((dh + dlo) * (sh + slo)).sum((1, 2)) + wq.sum(1)
        dloga[:, sl] = dcl.flip(1).cumsum(1).flip(1) + tail[:, None]
    group = sc.bwd_head_group(heads_per_bc)

    def heads_summed(t):  # the heads of each group in order, then the groups in order
        return t.reshape(rows, heads_per_bc // group, group, s, n).sum(2).sum(1)

    return (dx.to(x.dtype), (dloga / a.float()).to(a.dtype), heads_summed(db).to(b.dtype),
            heads_summed(dc).to(c.dtype))


def test_ssd_bwd_hi_lo_emulation_holds_the_bf16_bar():
    """The tensor-core backward feeds its f32 operands (the decayed T×T
    tiles, the states, the weighted dy) to bf16 ``wgmma`` as hi + lo pairs
    and sums db and dc over groups of 8 heads: emulated at mamba2-2.7b's
    P, N and chunk with 8 heads sharing b/c, each gradient stays within the
    bf16 bar (2e-2 of its largest magnitude) of the plain backward, which
    the f32 JAX gradient holds (test_torch_train.py).  bf16 operands alone
    meet that bar too (dx, db and dc are rounded to bf16 either way); what
    the lo parts keep is da, an f32 output, within the f32 bar (2e-4),
    which bf16 operands alone miss."""
    bh, s, p, n, heads, chunk = 16, 768, 64, 128, 8, 256
    x, a, b, c = _np_ssd(bh, s, p, n, seed=4, rows_bc=bh // heads)
    dy = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    x, b, c, dy = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, b, c, dy))
    a = torch.from_numpy(a)
    assert sc.bwd_route(x.dtype, p, n, chunk) == "tensor_core"
    assert sc.bwd_head_group(heads) == 8 and sc.bwd_head_group(80) == 8
    want = sc.ssd_scan_bwd(x, a, b, c, dy, chunk, heads_per_bc=heads)
    got = _ssd_bwd_tensor_core_emulated(x, a, b, c, dy, chunk, heads)
    bf16_only = _ssd_bwd_tensor_core_emulated(x, a, b, c, dy, chunk, heads, lo=False)
    for name, g, o, w in zip(("dx", "da", "db", "dc"), got, bf16_only, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        top = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2e-2 * top, name
        assert float((o.float() - w.float()).abs().max()) <= 2e-2 * top, name
    top = float(want[1].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= 2e-4 * top
    assert float((bf16_only[1] - want[1]).abs().max()) > 2e-4 * top


def test_ssd_rejects_bad_inputs():
    x, a, b, c = (torch.from_numpy(t) for t in _np_ssd(4, 32, 4, 8, seed=0, rows_bc=2))
    with pytest.raises(ValueError, match="multiple of chunk"):
        sc.ssd_scan(x, a, b, c, 24, heads_per_bc=2)
    with pytest.raises(ValueError, match="do not serve"):
        sc.ssd_scan(x, a, b, c, 16, heads_per_bc=3)
    with pytest.raises(TypeError, match="share"):
        sc.ssd_scan(x, a, b.double(), c, 16, heads_per_bc=2)


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("n,d", [(64, 128), (100, 256), (257, 512), (64, 4096), (64, 3584),
                                 (64, 7168)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_plain_matches_pallas(n, d, dtype):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    scale = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    got = rn.rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(scale).to(dtype))
    assert got.dtype == dtype
    jd = JNP[dtype]
    pallas = jax_rms_norm_fused(jnp.asarray(x, jd), jnp.asarray(scale, jd),
                                interpret=True, block_n=64)
    twin = jax_layers.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale, jd))
    tol = K2_TOL[dtype]
    for want in (pallas, twin):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_rms_norm_rejects_bad_inputs():
    with pytest.raises(ValueError, match="scale"):
        rn.rms_norm(torch.zeros(4, 3), torch.zeros(4))
    with pytest.raises(TypeError, match="share"):
        rn.rms_norm(torch.zeros(4, 3), torch.zeros(3, dtype=torch.bfloat16))


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


def test_header_edit_renames_every_library(monkeypatch, tmp_path):
    """A shared ``csrc/*.cuh`` enters every library's hash: editing one
    gives every kernel a new library name, so no stale build loads."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._target(name)[1] for name in _build.SIGNATURES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(name)[1] for name in _build.SIGNATURES}
    assert all(before[n] != after[n] for n in _build.SIGNATURES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    again = {name: _build._target(name)[1] for name in _build.SIGNATURES}
    assert all(again[n] != after[n] for n in _build.SIGNATURES)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (F32, 128, True, "rows"), (F32, 256, True, "rows"),  # the e2e path's layer widths
    (F32, 172, True, "rows"),  # its output width: 43 quads, the last lanes masked
    (F32, 4, True, "rows"), (F32, 512, True, "rows"),  # one quad; ROWS_MAX_D
    (F32, 516, True, "general"), (F32, 1024, True, "general"),  # past ROWS_MAX_D
    (F32, 6, True, "general"), (F32, 130, True, "general"),  # no whole quads of 4 values
    (F32, 36, False, "general"), (F32, 256, False, "general"),  # views off 16 bytes
    (F32, 0, True, "general"),
    (BF16, 256, True, "rows"), (BF16, 172, True, "rows"), (BF16, 36, True, "rows"),
    (BF16, 4, True, "rows"), (BF16, 512, True, "rows"),
    (BF16, 520, True, "general"), (BF16, 6, True, "general"), (BF16, 128, False, "general"),
    (torch.float16, 256, True, "general"), (torch.float64, 256, True, "general"),
])
def test_spmm_route_rule(dtype, d, aligned, want):
    assert ebs.route(dtype, d, aligned) == want
    assert ebs.ROWS_MAX_D == 512


@pytest.mark.parametrize("d,want", [(16, "cuda_core"), (64, "tensor_core"),
                                    (100, "cuda_core"), (128, "tensor_core"),
                                    (256, "tensor_core"), (192, "cuda_core")])
def test_attention_route_rule(d, want):
    """bf16 at head dim 64, 128 or 256 on aligned tensors takes the tensor
    cores with or without a window; f32, unaligned views and other head
    dims the CUDA cores."""
    for window in (None, 37, 64, 2048):
        assert fa.route(torch.bfloat16, d, window=window) == want
        # f32 keeps the CUDA-core kernel
        assert fa.route(torch.float32, d, window=window) == "cuda_core"
        assert fa.route(torch.bfloat16, d, aligned=False, window=window) == "cuda_core"


def test_attention_route_rule_at_head_dim_256():
    """recurrentgemma's bf16 calls (head dim 256, window 2048) and a
    windowed head dim 128 take the tensor-core route; its f32 calls (the
    check phases) and unaligned views the CUDA-core route, which stages
    its tiles to fit a block's shared memory."""
    assert fa.route(torch.bfloat16, 256, window=2048) == "tensor_core"
    assert fa.route(torch.bfloat16, 256) == "tensor_core"
    assert fa.route(torch.bfloat16, 128, window=64) == "tensor_core"
    assert fa.route(torch.float32, 256) == fa.route(torch.float32, 256, window=2048) == "cuda_core"
    assert fa.route(torch.bfloat16, 256, aligned=False, window=2048) == "cuda_core"
    assert fa._MAX_HEAD_DIM == 256


@pytest.mark.parametrize("k,m,want", [
    (256, 256, "tensor_core"), (512, 256, "tensor_core"), (64, 136, "tensor_core"),
    (512, 172, "cuda_core"),  # m % 8 == 4: a bf16 row of 344 bytes breaks TMA's stride rule
    (130, 256, "cuda_core"), (7, 3, "cuda_core"), (0, 8, "cuda_core"), (8, 8, "tensor_core"),
])
def test_graduate_route_rule(k, m, want):
    assert fg.route(torch.bfloat16, k, m) == want
    assert fg.route(torch.float32, k, m) == "cuda_core"  # the GNN path, TF32 off
    assert fg.route(torch.bfloat16, k, m, aligned=False) == "cuda_core"


def test_ssd_route_rule():
    """mamba2-2.7b's served scan (bf16, P = 64, N = 128, chunk 256) takes
    the tensor cores; f32, other head or state dims, chunks that are not
    a multiple of 64 and unaligned tensors keep the CUDA-core kernel."""
    cfg = get_config("mamba2-2.7b")
    bf = torch.bfloat16
    p, n, chunk = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk
    assert sc.route(bf, p, n, chunk) == "tensor_core"
    assert sc.route(bf, p, 64, 64) == "tensor_core"
    assert sc.route(torch.float32, p, n, chunk) == "cuda_core"  # [lm-check] runs f32
    assert sc.route(bf, 16, n, chunk) == "cuda_core"
    assert sc.route(bf, p, 32, chunk) == "cuda_core"
    assert sc.route(bf, p, n, 100) == "cuda_core"
    assert sc.route(bf, p, n, 512) == "cuda_core"  # past the kernels' 256-step chunk
    assert sc.route(bf, p, n, chunk, aligned=False) == "cuda_core"
    smoke = get_smoke_config("mamba2-2.7b")
    assert sc.route(bf, smoke.ssm_head_dim, smoke.ssm_state, smoke.ssd_chunk) == "cuda_core"


def test_ssd_bwd_route_rule():
    """The backward takes the forward's rule: mamba2-2.7b's [train] scan
    (bf16, P = 64, N = 128, chunk 256) on the tensor cores; f32
    ([train-check]), the smoke widths, other shapes and unaligned inputs on
    the CUDA cores.  Its blocks sum db and dc over groups of up to 8 heads
    that divide the heads a b/c row serves."""
    cfg = get_config("mamba2-2.7b")
    bf = torch.bfloat16
    p, n, chunk = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk
    for args in ((bf, p, n, chunk), (bf, p, 64, 64), (torch.float32, p, n, chunk),
                 (bf, 16, n, chunk), (bf, p, 32, chunk), (bf, p, n, 100), (bf, p, n, 512)):
        assert sc.bwd_route(*args) == sc.route(*args)
    assert sc.bwd_route(bf, p, n, chunk) == "tensor_core"
    assert sc.bwd_route(torch.float32, p, n, chunk) == "cuda_core"
    assert sc.bwd_route(bf, p, n, chunk, aligned=False) == "cuda_core"
    smoke = get_smoke_config("mamba2-2.7b")
    assert sc.bwd_route(bf, smoke.ssm_head_dim, smoke.ssm_state, smoke.ssd_chunk) == "cuda_core"
    heads = 2 * cfg.d_model // cfg.ssm_head_dim  # 80 heads share one b/c row
    assert [sc.bwd_head_group(h) for h in (heads, 1, 3, 4, 12, 7, 9)] == [8, 1, 3, 4, 6, 7, 3]


def _k5_resident_widths() -> list[int]:
    """Every width the served and trained models normalise: qwen3's d_model
    and head dim, mamba's d_model and inner width, deepseek-moe's,
    recurrentgemma's, qwen2-7b's and arctic's d_model."""
    q, m, ds, rg, q2, arc = (get_config(a) for a in (
        "qwen3-14b", "mamba2-2.7b", "deepseek-moe-16b", "recurrentgemma-9b", "qwen2-7b",
        "arctic-480b"))
    assert (ds.d_model, rg.d_model, q2.d_model, arc.d_model) == (2048, 4096, 3584, 7168)
    return [q.d_model, q.head_dim, m.d_model, 2 * m.d_model, ds.d_model, rg.d_model, q2.d_model,
            arc.d_model]


# musicgen's and starcoder2's d_model (no path on the card runs them) and odd widths
K5_GENERAL_WIDTHS = (get_config("musicgen-medium").d_model, get_config("starcoder2-3b").d_model,
                     100, 256, 512, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_route_rule(dtype):
    """Every width the served and trained models normalise takes the
    resident route (qwen2-7b's 3584 and arctic's 7168 among them); other
    widths and unaligned views take the general one."""
    for d in _k5_resident_widths():
        assert rn.route(dtype, d) == "resident"
        assert rn.route(dtype, d, aligned=False) == "general"
    assert K5_GENERAL_WIDTHS[:2] == (1536, 3072)
    for d in K5_GENERAL_WIDTHS:
        assert rn.route(dtype, d) == "general"


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


def test_split_counts_stay_empty_on_the_cpu():
    """K1's split counters live on the card: CPU calls, the rows route's
    shape with a segment past any slab included, leave them at (0, 0)
    without making one."""
    feats = torch.ones(3, 128)
    m = 10_000  # one segment of 10,000 edges
    ebs.segment_reduce_sorted(feats, torch.zeros(m, dtype=torch.int32), torch.ones(m),
                              torch.tensor([0, m], dtype=torch.int32))
    assert ebs.split_counts.value == (0, 0)
    ebs.split_counts.reset()
    assert ebs.split_counts.value == (0, 0)


def test_cpu_paths_never_launch():
    counts = (ebs.launches, fg.launches, fa.launches, sc.launches, rn.launches,
              ebs.rows_launches, ebs.general_launches,
              fg.tensor_core_launches, fg.cuda_core_launches,
              fa.tensor_core_launches, fa.cuda_core_launches,
              sc.tensor_core_launches, sc.cuda_core_launches,
              rn.resident_launches, rn.general_launches)
    before = [c.value for c in counts]
    ops.broadcast_aggregate(
        torch.ones(2, 2), torch.tensor([0, 1]), torch.tensor([1, 0]),
        torch.ones(2), 2,
    )
    ebs.segment_reduce_sorted(  # the rows route's shape, on the CPU
        torch.ones(3, 128), torch.tensor([0, 2], dtype=torch.int32), torch.ones(2),
        torch.tensor([0, 1, 2], dtype=torch.int32),
    )
    ops.graduate(torch.ones(2, 2), torch.ones(2, 2), torch.ones(2))
    bf = torch.bfloat16
    ops.graduate(torch.ones(3, 8, dtype=bf), torch.ones(8, 16, dtype=bf), torch.ones(16, dtype=bf))
    ops.attention(torch.ones(1, 2, 3, 4), torch.ones(1, 1, 3, 4), torch.ones(1, 1, 3, 4))
    ops.attention(*(torch.ones(1, h, 3, 64, dtype=bf) for h in (2, 1, 1)))
    ops.ssd(torch.ones(2, 4, 2), torch.ones(2, 4), torch.ones(1, 4, 3), torch.ones(1, 4, 3),
            4, heads_per_bc=2)
    bc = torch.ones(1, 64, 128, dtype=bf)  # the tensor-core route's shape, on the CPU
    ops.ssd(torch.ones(2, 64, 64, dtype=bf), torch.full((2, 64), 0.9), bc, bc, 64, heads_per_bc=2)
    ops.rms_norm(torch.ones(2, 3, 4), torch.zeros(4))
    ops.rms_norm(torch.ones(3, 5120, dtype=bf), torch.zeros(5120, dtype=bf))
    assert [c.value for c in counts] == before


# ------------------------------------------------------- backward routes


def _unaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose data starts 2 bytes past a
    16-byte boundary (a view into a larger buffer)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 128, "tensor_core"),  # [train]'s qwen3-14b heads
    (BF16, 64, "tensor_core"),
    (BF16, 100, "cuda_core"), (BF16, 16, "cuda_core"),
    (F32, 128, "cuda_core"),  # [train-check] runs f32
])
def test_attention_bwd_route_rule(dtype, d, want):
    """The backward takes the forward's rule on q's dtype and head dim, and
    any one of its five inputs off 16 bytes sends it to the CUDA cores."""
    q, k, v, out, dout = (torch.zeros(1, h, 70, d, dtype=dtype) for h in (4, 2, 2, 4, 4))
    assert fa.bwd_route(q, k, v, out, dout) == want == fa.route(dtype, d)
    for i in range(5):
        args = [q, k, v, out, dout]
        args[i] = _unaligned(args[i].shape, dtype)
        assert fa.bwd_route(*args) == "cuda_core"


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rms_norm_bwd_route_rule(dtype):
    """The forward's widths (``[train]``'s and ``[train-mesh]``'s among
    them, arctic's 7168 too) take the resident backward; other widths and
    inputs off 16 bytes take the general one."""
    for d in _k5_resident_widths():
        x, dy = torch.zeros(3, d, dtype=dtype), torch.zeros(3, d, dtype=dtype)
        scale = torch.zeros(d, dtype=dtype)
        assert rn.bwd_route(x, scale, dy) == "resident"
        assert rn.bwd_route(_unaligned((3, d), dtype), scale, dy) == "general"
        assert rn.bwd_route(x, _unaligned((d,), dtype), dy) == "general"
        assert rn.bwd_route(x, scale, _unaligned((3, d), dtype)) == "general"
    for d in K5_GENERAL_WIDTHS:
        assert rn.bwd_route(torch.zeros(3, d, dtype=dtype), torch.zeros(d, dtype=dtype),
                            torch.zeros(3, d, dtype=dtype)) == "general"


@pytest.mark.parametrize("n,d", [(4096, 3584), (250, 7168)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rms_norm_meta_notes_each_call_as_before(n, d, dtype):
    """On ``meta`` both directions at the widths that moved to the resident
    route note one call each, with the shapes and the cost the general
    route was planned at: ``kernel_cost`` reads the call, not its route."""
    from repro_torch.perf import hlo_cost

    assert rn.route(dtype, d) == "resident"
    x, dy = (torch.empty(n, d, dtype=dtype, device="meta") for _ in range(2))
    scale = torch.empty(d, dtype=dtype, device="meta")
    calls = []
    with _build.observe(lambda *call: calls.append(call)):
        out = rn.rms_norm(x, scale)
        dx, dscale = rn.rms_norm_bwd(x, scale, dy)
    noted = [(kernel, [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                       for t in (*inputs, *outputs)], attrs)
             for kernel, inputs, outputs, attrs in calls]
    name = str(dtype).removeprefix("torch.")
    row, vec = ((n, d), name), ((d,), name)
    assert noted == [("rms_norm", [row, vec, row], {}),
                     ("rms_norm_bwd", [row, vec, row, row, vec], {})]
    assert all(t.device.type == "meta" for t in (out, dx, dscale))
    size = dtype.itemsize
    for (kernel, tensors, _), flops, nbytes in zip(
            noted, (4 * n * d, 14 * n * d), ((2 * n * d + d) * size, (3 * n * d + 2 * d) * size)):
        cost = hlo_cost.kernel_cost(kernel, tensors)
        assert (cost["flops"], cost["bytes"], cost["transcendentals"]) == (flops, nbytes, n)


def test_attention_bwd_rejects_bad_inputs():
    q, k, v = (torch.zeros(1, h, 8, 16) for h in (4, 2, 2))
    out, dout = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention_bwd(q, k, v, out[:, :, :4], lse, dout)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention_bwd(q, k, v[:, :1], out, lse, dout)
    with pytest.raises(ValueError, match="shapes"):  # 4 q heads over 3 kv heads
        fa.flash_attention_bwd(q, *(torch.zeros(1, 3, 8, 16) for _ in range(2)), out, lse, dout)
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout.to(torch.bfloat16))
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention_bwd(*(t.double() for t in (q, k, v, out)), lse, dout.double())


def test_rms_norm_bwd_rejects_bad_inputs():
    x, scale = torch.zeros(4, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="scale"):
        rn.rms_norm_bwd(x, torch.zeros(4), x)
    with pytest.raises(ValueError, match="dy"):
        rn.rms_norm_bwd(x, scale, torch.zeros(4, 4))
    with pytest.raises(ValueError, match="dy"):
        rn.rms_norm_bwd(torch.zeros(2, 2, 3), scale, torch.zeros(2, 2, 3))
    with pytest.raises(TypeError, match="share"):
        rn.rms_norm_bwd(x, scale, x.to(torch.bfloat16))


def test_cpu_backward_never_launches():
    """The backward wrappers on CPU tensors of the new routes' shapes run
    the plain versions: no counter of either route moves."""
    counts = (fa.bwd_launches, fa.bwd_tensor_core_launches, fa.bwd_cuda_core_launches,
              rn.bwd_launches, rn.bwd_resident_launches, rn.bwd_general_launches,
              sc.bwd_launches, sc.bwd_tensor_core_launches, sc.bwd_cuda_core_launches)
    before = [c.value for c in counts]
    q, k, v, out, dout = (torch.ones(1, h, 3, 128, dtype=BF16) for h in (2, 1, 1, 2, 2))
    assert fa.bwd_route(q, k, v, out, dout) == "tensor_core"
    fa.flash_attention_bwd(q, k, v, out, torch.zeros(2, 3), dout)
    for d in (5120, 2048):
        x, scale = torch.ones(3, d, dtype=BF16), torch.zeros(d, dtype=BF16)
        assert rn.bwd_route(x, scale, x) == "resident"
        rn.rms_norm_bwd(x, scale, x)
    x, bc = torch.ones(2, 64, 64, dtype=BF16), torch.ones(1, 64, 128, dtype=BF16)
    assert sc.bwd_route(x.dtype, 64, 128, 64) == "tensor_core"
    sc.ssd_scan_bwd(x, torch.full((2, 64), 0.9), bc, bc, x, 64, heads_per_bc=2)
    assert [c.value for c in counts] == before
    assert set(fa.bwd_route_launches) == {"tensor_core", "cuda_core"}
    assert set(rn.bwd_route_launches) == {"resident", "general"}
    assert set(sc.bwd_route_launches) == {"tensor_core", "cuda_core"}


def test_build_keeps_the_ptxas_report(monkeypatch, tmp_path):
    """``resource_usage`` reads the registers and spills that ``ptxas -v``
    printed when a library was built (the report kept beside it)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert "-v" in _build.NVCC_FLAGS
    assert _build.resource_usage("rms_norm") == {}
    report = _build._target("rms_norm")[1].with_suffix(".ptxas.txt")
    report.write_text(
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    72 bytes stack frame, 36 bytes spill stores, 132 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 41088 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3barv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 0 barriers\n")
    assert _build.resource_usage("rms_norm") == {"_Z3fooPf": (128, 36, 132), "_Z3barv": (32, 0, 0)}
