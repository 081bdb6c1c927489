"""The port's RG-LRU block (``repro_torch/models/rglru.py``) and K6's plain
versions against the JAX package, on the CPU.

The block's parameters come from numpy seeds and go into both packages;
the recurrence (``rglru_scan_ref``: K6's chunked order, each step one
product and one sum, chunks joined by carries; ``chunk=None`` is the
sequential loop) is held against the loop, against the reference's
``jax.lax.associative_scan``, and its gradient (``rglru_scan_bwd_ref``)
against ``jax.vjp`` of it, at several chunk lengths and at S over several
chunks with a ragged last one.  On the CPU the wrappers
(``kernels/rglru_scan.py``) run the plain versions at ``CHUNK``; K6 itself
runs on the card in tests/test_torch_gpu.py.

Tolerances: 1e-6, relative to each tensor's largest magnitude where the
associative scan or the chunks sum in another order than the loop (the
scan and its gradient, the block over several chunks), elementwise for the
gates, the block and the decode step within one chunk (the same
operations in the same order, two CPU BLAS libraries); bitwise where the
order is the same (``chunk >= S`` and the loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import rglru as jrg
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as k6
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.models import rglru as trg

TOL = 1e-6
D_MODEL, D_RNN, CONV = 24, 32, 4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close_rel(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _block_params(seed: int) -> dict:
    """An RG-LRU block's leaves as f32 numpy at the init's scales, with
    ``lam`` spread so the decays differ by channel."""
    rng = np.random.default_rng(seed)
    nb, blk = 16, D_RNN // 16
    normal = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    return {"in1": normal(D_MODEL, D_RNN, s=D_MODEL**-0.5),
            "in2": normal(D_MODEL, D_RNN, s=D_MODEL**-0.5),
            "conv": normal(CONV, D_RNN, s=0.1),
            "w_r": normal(nb, blk, blk, s=blk**-0.5),
            "w_i": normal(nb, blk, blk, s=blk**-0.5),
            "lam": rng.uniform(-2.0, 2.0, D_RNN).astype(np.float32),
            "wo": normal(D_RNN, D_MODEL, s=D_RNN**-0.5)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _loop(a, w, h0=None):
    """The sequential loop, one f32 product then one f32 sum a step."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + w[:, t]
        out[:, t] = h
    return out


def _loop_bwd(a, h, dh, h0=None):
    """The loop's gradient, walking S downwards: ``g_t = dh_t +
    a_{t+1}·g_{t+1}``, ``dw = g``, ``da_t = g_t·h_{t-1}``, ``dh0 = a_0·g_0``."""
    s = a.shape[1]
    da, dw = torch.empty_like(a), torch.empty_like(a)
    g = dh[:, s - 1]
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            g = dh[:, t] + a[:, t + 1] * g
        dw[:, t] = g
        prev = h[:, t - 1] if t else (torch.zeros_like(g) if h0 is None else h0)
        da[:, t] = g * prev
    return da, dw, (None if h0 is None else a[:, 0] * g)


def _scan_inputs(b, s, r, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.999, size=(b, s, r)).astype(np.float32)
    w = rng.normal(size=(b, s, r)).astype(np.float32)
    h0 = rng.normal(size=(b, r)).astype(np.float32)
    dh = rng.normal(size=(b, s, r)).astype(np.float32)
    return a, w, h0, dh


def test_init_rglru_block_matches_jax_tree():
    """Same keys, shapes and dtypes as the JAX init (f32 and bf16), the
    block-diagonal gates halved until they divide d_rnn; the draws differ."""
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for d_rnn in (32, 24):
            want = jrg.init_rglru_block(jax.random.PRNGKey(0), D_MODEL, d_rnn, CONV, jdtype)
            gen = torch.Generator().manual_seed(0)
            got = trg.init_rglru_block(gen, D_MODEL, d_rnn, CONV, dtype, "cpu")
            assert got.keys() == want.keys()
            for key, a in want.items():
                assert tuple(got[key].shape) == a.shape, key
                assert got[key].dtype == getattr(torch, a.dtype.name), key
            assert torch.equal(got["lam"], torch.full((d_rnn,), 0.5))


def test_gates_forward_and_decode_match_jax():
    params = _block_params(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2, 5, D_RNN)).astype(np.float32)
    for got, want in zip(trg._gates(tp, _t(u)), jrg._gates(jp, jnp.asarray(u))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    x = rng.normal(size=(2, 20, D_MODEL)).astype(np.float32)
    want = jrg.rglru_forward(jp, jnp.asarray(x), jmamba.causal_conv1d)
    got, cache = trg.rglru_forward(tp, _t(x), return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    # the decode cache after the sequence: its conv window and final state,
    # as the reference's prefill rebuilds them
    u1 = jnp.asarray(x) @ jp["in1"]
    a, w = jrg._gates(jp, jmamba.causal_conv1d(u1, jp["conv"]))
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(u1[:, -(CONV - 1):]),
                               rtol=TOL, atol=TOL)
    _close_rel(cache["h"], jrg.rglru_scan(a, w)[:, -1])

    # decode steps from that cache, state and outputs
    jc = {"conv": jnp.asarray(cache["conv"].numpy()), "h": jnp.asarray(cache["h"].numpy())}
    tc = {k: v.clone() for k, v in cache.items()}
    for t in range(3):
        xt = rng.normal(size=(2, 1, D_MODEL)).astype(np.float32)
        jy, jc = jrg.rglru_decode_step(jp, jc, jnp.asarray(xt))
        ty, tc = trg.rglru_decode_step(tp, tc, _t(xt))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
        for key in ("conv", "h"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), rtol=TOL, atol=TOL)


def test_rglru_forward_cache_of_a_short_sequence_pads_the_conv_window():
    """Fewer tokens than the conv window holds: the window's head is the
    zeros the decode cache starts from."""
    tp = {k: _t(v) for k, v in _block_params(2).items()}
    x = _t(np.random.default_rng(3).normal(size=(1, 2, D_MODEL)).astype(np.float32))
    _, cache = trg.rglru_forward(tp, x, return_cache=True)
    u1 = x @ tp["in1"]
    assert cache["conv"].shape == (1, CONV - 1, D_RNN)
    assert torch.equal(cache["conv"][:, 0], torch.zeros(1, D_RNN))
    assert torch.equal(cache["conv"][:, 1:], u1)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_ref_matches_the_associative_scan(with_h0):
    a, w, h0, _ = _scan_inputs(2, 37, 16, seed=4)
    want = jrg.rglru_scan(jnp.asarray(a), jnp.asarray(w),
                          jnp.asarray(h0) if with_h0 else None)
    got = rglru_scan_ref(_t(a), _t(w), _t(h0) if with_h0 else None)
    assert got.dtype == torch.float32 and got.shape == a.shape
    _close_rel(got, want)
    # the wrapper on CPU tensors, and the op, are the plain version
    for fn in (k6.rglru_scan, ops.rglru_scan, trg.rglru_scan):
        assert torch.equal(fn(_t(a), _t(w), _t(h0) if with_h0 else None), got)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_ref_matches_autograd_and_jax_vjp(with_h0):
    a, w, h0, dh = _scan_inputs(2, 29, 16, seed=5)
    args = (a, w, h0) if with_h0 else (a, w)
    _, vjp = jax.vjp(lambda *xs: jrg.rglru_scan(*xs), *(jnp.asarray(x) for x in args))
    want = vjp(jnp.asarray(dh))
    h = rglru_scan_ref(*(_t(x) for x in args))
    da, dw, dh0 = rglru_scan_bwd_ref(_t(a), h, _t(dh), _t(h0) if with_h0 else None)
    assert (dh0 is None) != with_h0
    got = (da, dw, dh0) if with_h0 else (da, dw)
    leaves = [_t(x).requires_grad_() for x in args]
    auto = torch.autograd.grad(rglru_scan_ref(*leaves), leaves, _t(dh))
    for g, au, wa in zip(got, auto, want):
        _close_rel(g, au.numpy())
        _close_rel(g, wa)
    # the wrapper, and the autograd Function driven on CPU tensors, take it too
    again = k6.rglru_scan_bwd(_t(a), h, _t(dh), _t(h0) if with_h0 else None)
    for g, x in zip(again, (da, dw, dh0)):
        assert (g is None and x is None) or torch.equal(g, x)
    leaves = [_t(x).requires_grad_() for x in args]
    fn_grads = torch.autograd.grad(k6.rglru_scan_grad(*leaves), leaves, _t(dh))
    for g, x in zip(fn_grads, got):
        assert torch.equal(g, x)


def test_rglru_scan_rejects_bad_inputs():
    a, w, h0, _ = (_t(x) for x in _scan_inputs(1, 4, 8, seed=6))
    with pytest.raises(ValueError, match="chunk"):
        k6.rglru_scan(a, w, chunk=0)
    with pytest.raises(ValueError, match="chunk"):
        k6.rglru_scan_bwd(a, a, w, chunk=None)
    with pytest.raises(TypeError, match="float32"):
        k6.rglru_scan(a.double(), w.double())
    with pytest.raises(ValueError, match="one shape"):
        k6.rglru_scan(a, w[:, :3])
    with pytest.raises(ValueError, match="h0"):
        k6.rglru_scan(a, w, h0[:, :4])
    with pytest.raises(ValueError, match="one shape"):
        k6.rglru_scan_bwd(a, a, w[:, :, :4])


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [37, 2 * k6.CHUNK + 3])
@pytest.mark.parametrize("chunk", [4, 7, k6.CHUNK])
def test_chunked_rglru_scan_ref_matches_the_loop_and_jax(chunk, s, with_h0):
    """K6's chunked order against the loop and the associative scan, and
    its backward against the loop's and ``jax.vjp``, with a ragged last
    chunk (S is no multiple of any chunk length here)."""
    a, w, h0, dh = _scan_inputs(2, s, 16, seed=7 + s + chunk)
    h0t = _t(h0) if with_h0 else None
    got = rglru_scan_ref(_t(a), _t(w), h0t, chunk)
    loop = _loop(_t(a), _t(w), h0t)
    _close_rel(got, loop.numpy())
    args = (a, w, h0) if with_h0 else (a, w)
    want, vjp = jax.vjp(lambda *xs: jrg.rglru_scan(*xs), *(jnp.asarray(x) for x in args))
    _close_rel(got, want)
    grads = rglru_scan_bwd_ref(_t(a), got, _t(dh), h0t, chunk)
    assert (grads[2] is None) != with_h0
    loop_grads = _loop_bwd(_t(a), got, _t(dh), h0t)
    for g, lo, wa in zip(grads, loop_grads, vjp(jnp.asarray(dh))):
        if g is not None:
            _close_rel(g, lo.numpy())
            _close_rel(g, wa)
    # the wrappers on CPU tensors take the plain versions at the chunk asked for
    assert torch.equal(_bits(k6.rglru_scan(_t(a), _t(w), h0t, chunk=chunk)), _bits(got))
    for g, x in zip(k6.rglru_scan_bwd(_t(a), got, _t(dh), h0t, chunk=chunk), grads):
        assert (g is None and x is None) or torch.equal(_bits(g), _bits(x))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_ref_chunk_at_least_s_is_the_loop_bitwise(with_h0):
    """One chunk (``chunk >= S``, or None) is the sequential loop bit for
    bit, forward and backward; so is any S up to ``CHUNK`` at the default."""
    for s in (1, 29, k6.CHUNK):
        a, w, h0, dh = (_t(x) for x in _scan_inputs(2, s, 16, seed=11 + s))
        h0 = h0 if with_h0 else None
        loop = _loop(a, w, h0)
        loop_grads = _loop_bwd(a, loop, dh, h0)
        for chunk in (None, s, s + 5, k6.CHUNK):
            assert torch.equal(_bits(rglru_scan_ref(a, w, h0, chunk)), _bits(loop)), chunk
            for g, x in zip(rglru_scan_bwd_ref(a, loop, dh, h0, chunk), loop_grads):
                assert (g is None and x is None) or torch.equal(_bits(g), _bits(x)), chunk


def test_rglru_forward_over_several_chunks_matches_jax():
    """The block at S over three chunks of ``CHUNK`` (the wrapper's default
    on the CPU) against the reference's block."""
    params = _block_params(12)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    x = np.random.default_rng(13).normal(size=(2, 2 * k6.CHUNK + 3, D_MODEL)).astype(np.float32)
    want = jrg.rglru_forward(jp, jnp.asarray(x), jmamba.causal_conv1d)
    _close_rel(trg.rglru_forward(tp, _t(x)), want)
