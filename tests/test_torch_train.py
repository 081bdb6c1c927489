"""The port's training slice against the JAX package, on the CPU.

``lm_loss`` and its gradients (every ported architecture at its smoke
size, f32), the MoE layer's gradient, AdamW and its schedule, the train
step, checkpoints (both directions between the packages), the synthetic
data pipeline and the plain versions of K3's, K4's and K5's backward.
Inputs come from numpy seeds;
the JAX parameters are carried over by ``params_from_numpy``.  On the CPU
every kernel wrapper runs its plain version and autograd differentiates it
(the backward kernels run on the card in tests/test_torch_gpu.py).

Tolerances: the loss 1e-5; each gradient leaf 1e-4 of its largest
magnitude (two CPU BLAS libraries and a one-pass softmax against the JAX
blockwise one sum in other orders, and the gradients of small leaves
inherit the loss's rounding); AdamW and the schedule 1e-6 in f32 and
2e-2 with bf16 moments (one bf16 rounding of the moments); the train
step's losses 1e-4 over 8 steps; the plain backward versions 1e-5 against
autograd and against ``jax.vjp`` (K4's relative to each gradient's largest
magnitude: ``da`` is a reverse cumsum of terms of either sign); the MoE
layer's gradients 1e-5 of each one's largest magnitude; tokens, labels and
checkpoints exactly.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.data import pipeline as jpipe
from repro.models import layers as jll
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.mamba import ssd_chunked
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rms_norm as rn
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    rms_norm_bwd_ref,
    rms_norm_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import init_train_state, make_train_step, train_state_from_numpy

CPU = torch.device("cpu")
B, S = 2, 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jax_get_smoke_config(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, get_smoke_config(arch)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        batch["embeddings"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return batch


# ------------------------------------------------------------- lm_loss


@pytest.mark.parametrize("arch", list_archs())
def test_lm_loss_and_gradients_match_jax(arch):
    jcfg, jparams, tcfg = _models(arch)
    batch = _batch(tcfg, seed=3)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    params = tlm.params_from_numpy(tcfg, _np_tree(jparams), CPU)
    live = [p.requires_grad_() for p in topt.tree_leaves(params)]
    loss = tlm.lm_loss(params, tcfg, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    want = jax.tree.leaves(jgrads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        tol = 1e-4 * float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def test_remat_checkpoints_blocks_and_keeps_the_gradient():
    _, jparams, tcfg = _models("qwen3-14b")
    batch = {k: _t(v) for k, v in _batch(tcfg, seed=4).items()}
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = tlm.params_from_numpy(cfg, _np_tree(jparams), CPU)
        live = [p.requires_grad_() for p in topt.tree_leaves(params)]
        loss = tlm.lm_loss(params, cfg, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, live))
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_hybrid_remat_checkpoints_superblocks_and_keeps_the_gradient(monkeypatch):
    """recurrentgemma's superblocks and tail layers each run under
    ``torch.utils.checkpoint`` when remat is on, with the same loss and
    gradients as without it."""
    _, jparams, tcfg = _models("recurrentgemma-9b")
    batch = {k: _t(v) for k, v in _batch(tcfg, seed=6).items()}
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn.__name__) or real(fn, *a, **kw))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = tlm.params_from_numpy(cfg, _np_tree(jparams), CPU)
        live = [p.requires_grad_() for p in topt.tree_leaves(params)]
        loss = tlm.lm_loss(params, cfg, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, live))
    assert len(calls) == 1 + 2  # one superblock, two tail layers (smoke: 5 layers)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cf,tied", [(3.0, False), (1.0, False), (1.0, True)])
def test_moe_gradients_match_jax(cf, tied):
    """The MoE layer's gradients (router, experts, input) against
    ``jax.grad``: drop-free, dropping, and with exactly tied gates."""
    rng = np.random.default_rng(11)
    b, s, d, f, e, k = 2, 64, 12, 10, 8, 2
    params = {"router": (0.5 * rng.normal(size=(d, e))).astype(np.float32),
              "gate": (0.3 * rng.normal(size=(e, d, f))).astype(np.float32),
              "up": (0.3 * rng.normal(size=(e, d, f))).astype(np.float32),
              "down": (0.3 * rng.normal(size=(e, f, d))).astype(np.float32)}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if tied:
        x[:, 1::2] = x[:, ::2]
    dy = rng.normal(size=(b, s, d)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jmoe.moe_forward(p, xx, top_k=k, capacity_factor=cf) * dy)

    jp, jx = jax.grad(jloss, argnums=(0, 1))({n: jnp.asarray(v) for n, v in params.items()},
                                             jnp.asarray(x))
    names = sorted(params)
    leaves = [_t(params[n]).requires_grad_() for n in names] + [_t(x).requires_grad_()]
    out = tmoe.moe_forward(dict(zip(names, leaves)), leaves[-1], top_k=k, capacity_factor=cf)
    got = torch.autograd.grad((out * _t(dy)).sum(), leaves)
    for g, w in zip(got, [jp[n] for n in names] + [jx]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()))


# ------------------------------------------------------------- adamw


def _random_tree(rng, leaf):
    return {
        "w": leaf(rng, (6, 5)),
        "blocks": {"a": leaf(rng, (3, 4, 4)), "b": leaf(rng, (3, 4)), "norm": leaf(rng, (7,))},
        "bias": leaf(rng, (5,)),
    }


@pytest.mark.parametrize("moment_dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_adamw_update_matches_jax(moment_dtype, tol):
    rng = np.random.default_rng(7)
    normal = lambda r, shape: r.normal(size=shape).astype(np.float32)  # noqa: E731
    params = _random_tree(rng, normal)
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=0.5,
                           moment_dtype=moment_dtype)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jp, cfg)
    tp = jax.tree.map(_t, params)
    ts = topt.adamw_init(tp, tcfg)
    for _ in range(5):  # through the warmup and into the cosine
        grads = _random_tree(rng, normal)
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js, cfg)
        tp, ts, tm = topt.adamw_update(tp, jax.tree.map(_t, grads), ts, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 5 and ts["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=tol, atol=tol)
    assert all(m.dtype == getattr(torch, moment_dtype) for m in topt.tree_leaves(ts["m"]))


def test_lr_schedule_matches_jax():
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    tcfg = topt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        want = float(jopt.lr_schedule(cfg, jnp.asarray(s, jnp.int32)))
        got = topt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-9)
    unit = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(topt.lr_schedule(unit, torch.tensor(s))) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0 and abs(lrs[2] - 1.0) < 1e-6 and lrs[3] < lrs[2] and lrs[4] < 1e-6


def test_global_norm_sums_leaves_in_sorted_key_order():
    tree = {"b": torch.full((3,), 2.0), "a": {"y": torch.ones(4), "x": torch.zeros(2)}}
    assert [t.numel() for t in topt.tree_leaves(tree)] == [2, 4, 3]
    assert float(topt.global_norm(tree)) == pytest.approx(4.0)


# ------------------------------------------------------------- train step


def test_train_step_matches_jax():
    """8 steps of deepseek-7b smoke from the same state and batch as the
    reference's test_adamw_decreases_loss."""
    cfg = jax_get_smoke_config("deepseek-7b")
    opt_cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100)
    jstate = jinit_train_state(cfg, opt_cfg, jax.random.PRNGKey(0))
    k = jax.random.PRNGKey(1)
    jbatch = {
        "tokens": jax.random.randint(k, (2, 32), 0, cfg.vocab_size),
        "labels": jax.random.randint(k, (2, 32), 0, cfg.vocab_size),
    }
    tcfg = get_smoke_config("deepseek-7b")
    tstate = train_state_from_numpy(tcfg, _np_tree(jstate), CPU)
    tbatch = {key: _t(v) for key, v in jbatch.items()}
    jstep = jax.jit(jmake_train_step(cfg, opt_cfg))
    tstep = make_train_step(tcfg, topt.AdamWConfig(**dataclasses.asdict(opt_cfg)))
    jl, tl = [], []
    for _ in range(8):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert tl[-1] < tl[0], tl
    assert int(tstate["opt"]["step"]) == 8
    assert set(tm) == {"loss", "grad_norm", "lr"}


def test_init_train_state_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = get_smoke_config("qwen3-14b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, topt.AdamWConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.make_global_batch(0, 0, 2, 8, cfg.vocab_size)


# ------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    state = {"a": torch.arange(12.0).reshape(3, 4), "n": {"b": torch.ones((5,))}}
    for s in (1, 2, 3):
        mgr.save(s, {"a": state["a"] * s, "n": {"b": state["n"]["b"] * s}})
    mgr.wait()
    assert mgr.latest_step() == 3
    restored, step = mgr.restore(state)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(12.0).reshape(3, 4) * 3)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_000000002", "step_000000003"]


def test_checkpoint_crash_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    state = {"w": torch.ones((4, 4))}
    mgr.save(7, state)
    os.makedirs(tmp_path / "step_000000008.tmp")
    (tmp_path / "step_000000008.tmp" / "garbage.npy").write_bytes(b"xx")
    assert mgr.latest_step() == 7
    restored, step = mgr.restore(state)
    assert step == 7
    torch.testing.assert_close(restored["w"], state["w"], rtol=0, atol=0)


def test_train_resume_bit_exact(tmp_path):
    """Stop after step 2, restore, take step 3: the same bits as step 3
    uninterrupted (the reference's test, on the port)."""
    cfg = get_smoke_config("qwen3-14b")
    opt_cfg = topt.AdamWConfig(lr=1e-3)
    rng = np.random.default_rng(1)
    batch = {key: _t(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
             for key in ("tokens", "labels")}
    step = make_train_step(cfg, opt_cfg)
    state = init_train_state(cfg, opt_cfg, seed=0, device=CPU)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for _ in range(2):
        state, _ = step(state, batch)
    mgr.save(2, state)
    state, _ = step(state, batch)
    want = [t.clone() for t in topt.tree_leaves(state["params"])]

    state2, at = mgr.restore(init_train_state(cfg, opt_cfg, seed=5, device=CPU))
    assert at == 2 and int(state2["opt"]["step"]) == 2
    state2, _ = step(state2, batch)
    for a, b in zip(topt.tree_leaves(state2["params"]), want):
        assert torch.equal(a, b)


def _mixed_state(rng):
    """A tree with f32, int32 and bf16 leaves."""
    return {
        "params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                   "emb": rng.normal(size=(5, 2)).astype(ml_dtypes.bfloat16)},
        "opt": {"step": np.asarray(3, np.int32), "m": {"w": rng.normal(size=(4, 3)).astype(np.float32)}},
    }


def _torch_tree(tree):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    return jax.tree.map(conv, tree)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    state = _mixed_state(np.random.default_rng(2))
    JCheckpointManager(str(tmp_path), async_save=False).save(4, jax.tree.map(jnp.asarray, state))
    restored, step = CheckpointManager(str(tmp_path)).restore(_torch_tree(state))
    assert step == 4
    assert restored["params"]["emb"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32
    for got, want in zip(topt.tree_leaves(restored), topt.tree_leaves(_torch_tree(state))):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_port_checkpoint_restores_in_jax_with_the_same_bytes(tmp_path):
    state = _mixed_state(np.random.default_rng(3))
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(4, _torch_tree(state))
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(4, jax.tree.map(jnp.asarray, state))
    port, ref = tmp_path / "port" / "step_000000004", tmp_path / "jax" / "step_000000004"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name.endswith(".npy"):
            assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    assert json.loads((port / "manifest.json").read_text()) == json.loads((ref / "manifest.json").read_text())
    assert (tmp_path / "port" / "LATEST").read_text() == (tmp_path / "jax" / "LATEST").read_text()
    restored, step = JCheckpointManager(str(tmp_path / "port"), async_save=False).restore(state)
    assert step == 4
    # the reference's own restore returns a bfloat16 leaf as raw 2-byte voids
    assert restored["params"]["emb"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(restored["params"]["emb"].view(np.uint16),
                                  state["params"]["emb"].view(np.uint16))
    for key in ("w",):
        np.testing.assert_array_equal(restored["params"][key], state["params"][key])
    np.testing.assert_array_equal(restored["opt"]["m"]["w"], state["opt"]["m"]["w"])
    assert restored["opt"]["step"] == 3


def test_bf16_leaf_bytes_match_numpy_save_of_ml_dtypes(tmp_path):
    from repro_torch.train import checkpoint as tck

    a = np.random.default_rng(0).normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    np.save(tmp_path / "want.npy", a)
    arr, dtype = tck._to_host(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
    assert dtype == "bfloat16"
    tck._save_leaf(str(tmp_path / "got.npy"), arr, dtype)
    assert (tmp_path / "got.npy").read_bytes() == (tmp_path / "want.npy").read_bytes()
    back = tck._load_leaf(str(tmp_path / "want.npy"), dtype)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(), a.astype(np.float32))


# ------------------------------------------------------------- data pipeline


@pytest.mark.parametrize("seed,step,batch", [(0, 0, 2), (0, 7, 3), (5, 1, 1), (11, 123, 4)])
def test_global_batch_tokens_equal_the_reference(seed, step, batch):
    seq, vocab = 16, 1000
    want = jpipe.make_global_batch(seed, step, batch, seq, vocab)
    got = tpipe.make_global_batch(seed, step, batch, seq, vocab, device="cpu")
    assert set(got) == {"tokens", "labels"}
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(
        tpipe._tokens_for_slice(seed, step, 1, batch, seq, vocab),
        jpipe._tokens_for_slice(seed, step, 1, batch, seq, vocab),
    )


def test_embeddings_batch_is_a_function_of_seed_and_step():
    a = tpipe.make_global_batch(3, 2, 2, 8, 50, device="cpu", d_model=6)
    b = tpipe.make_global_batch(3, 2, 2, 8, 50, device="cpu", d_model=6)
    c = tpipe.make_global_batch(3, 4, 2, 8, 50, device="cpu", d_model=6)
    assert set(a) == {"embeddings", "labels"}
    assert a["embeddings"].shape == (2, 8, 6) and a["embeddings"].dtype == torch.float32
    assert torch.equal(a["embeddings"], b["embeddings"])
    assert not torch.equal(a["embeddings"], c["embeddings"])
    want = jpipe.make_global_batch(3, 2, 2, 8, 50, d_model=6)
    np.testing.assert_array_equal(a["labels"].numpy(), np.asarray(want["labels"]))


def test_stream_yields_steps_in_order():
    stream = tpipe.SyntheticLMStream(9, 2, 8, 100, device="cpu", start_step=3, depth=2)
    try:
        for want_step in (3, 4, 5, 6):
            step, batch = next(stream)
            assert step == want_step
            ref = tpipe.make_global_batch(9, step, 2, 8, 100, device="cpu")
            assert torch.equal(batch["tokens"], ref["tokens"])
            assert torch.equal(batch["labels"], ref["labels"])
    finally:
        stream.close()


# ------------------------------------------------------------- backward plain versions


ATTN_CASES = [  # (b, hq, hkv, s, d, causal)
    (2, 4, 2, 16, 8, True),
    (1, 6, 1, 13, 16, True),
    (1, 4, 4, 9, 8, False),
    (2, 8, 2, 70, 32, True),
]


def _attn_inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))
    return [rng.normal(size=shape).astype(np.float32) for shape in shapes]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", ATTN_CASES)
def test_flash_attention_bwd_ref_matches_autograd_and_jax(b, hq, hkv, s, d, causal):
    q, k, v, do = _attn_inputs(b, hq, hkv, s, d, seed=s)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, causal)
    auto = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(), _t(do), causal)
    _, vjp = jax.vjp(lambda a, b_, c: jll.blockwise_attention(a, b_, c, causal=causal), q, k, v)
    want = vjp(jnp.asarray(do))
    for g, a, w in zip(got, auto, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors is the plain version
    lse = torch.empty((b * hq, s))
    fwd = fa.flash_attention(tq.detach(), tk.detach(), tv.detach(), causal, lse=lse)
    again = fa.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), fwd, lse, _t(do), causal)
    for g, a in zip(again, got):
        assert torch.equal(g, a)


@pytest.mark.parametrize("s,window", [(40, 16), (33, 8)])
def test_windowed_flash_attention_bwd_ref_matches_autograd_and_jax(s, window):
    """recurrentgemma's local attention (head dim 256, 16 query heads on
    one KV head, window < S) against ``jax.vjp`` of
    ``blockwise_attention(window=)``."""
    q, k, v, do = _attn_inputs(1, 16, 1, s, 256, seed=s + window)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, True, window)
    auto = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    got = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(), _t(do),
                                  True, window)
    _, vjp = jax.vjp(lambda a, b_, c: jll.blockwise_attention(a, b_, c, window=window,
                                                              block_kv=s), q, k, v)
    want = vjp(jnp.asarray(do))
    for g, a, w in zip(got, auto, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    lse = torch.empty((16, s))
    fwd = fa.flash_attention(tq.detach(), tk.detach(), tv.detach(), True, lse=lse, window=window)
    again = fa.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), fwd, lse, _t(do), True,
                                   window)
    for g, a in zip(again, got):
        assert torch.equal(g, a)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    fn_grads = torch.autograd.grad(fa.flash_attention_grad(*leaves, True, window), leaves, _t(do))
    for g, a in zip(fn_grads, got):
        torch.testing.assert_close(g, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d", [(7, 16), (33, 128), (4, 300), (5, 3584), (3, 7168)])
def test_rms_norm_bwd_ref_matches_autograd_and_jax(n, d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    scale = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    dy = rng.normal(size=(n, d)).astype(np.float32)
    tx, ts = _t(x).requires_grad_(), _t(scale).requires_grad_()
    auto = torch.autograd.grad(rms_norm_ref(tx, ts), (tx, ts), _t(dy))
    got = rms_norm_bwd_ref(_t(x), _t(scale), _t(dy))
    _, vjp = jax.vjp(jll.rms_norm, x, scale)
    want = vjp(jnp.asarray(dy))
    for g, a, w in zip(got, auto, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(rn.rms_norm_bwd(_t(x), _t(scale), _t(dy)), got))


SSD_CASES = [  # (batch, heads, heads_per_bc, chunks of 16); P = 8, N = 16
    (2, 3, 3, 2),
    (2, 3, 1, 3),
]


def _ssd_inputs(b, h, hpb, nc, seed):
    """x, a (decays in [0.05, 1]), b, c and dy for the port's layout."""
    rng = np.random.default_rng(seed)
    s, p, n = 16 * nc, 8, 16
    x = rng.normal(size=(b * h, s, p)).astype(np.float32)
    a = rng.uniform(0.05, 1.0, size=(b * h, s)).astype(np.float32)
    bm, cm = (rng.normal(size=(b * h // hpb, s, n)).astype(np.float32) for _ in range(2))
    dy = rng.normal(size=(b * h, s, p)).astype(np.float32)
    return x, a, bm, cm, dy


@pytest.mark.parametrize("b,h,hpb,nc", SSD_CASES)
def test_ssd_scan_bwd_ref_matches_autograd_and_jax(b, h, hpb, nc):
    x, a, bm, cm, dy = _ssd_inputs(b, h, hpb, nc, seed=nc)
    leaves = [_t(t).requires_grad_() for t in (x, a, bm, cm)]
    auto = torch.autograd.grad(ssd_scan_ref(*leaves, 16, hpb), leaves, _t(dy))
    got = ssd_scan_bwd_ref(_t(x), _t(a), _t(bm), _t(cm), _t(dy), 16, hpb)
    # the reference's jnp scan: [B, S, H, P] with B/C shared by the H heads of a row
    rows, heads, s = b * h // hpb, hpb, x.shape[1]

    def to_jax(t):
        return t.reshape(rows, heads, s, -1).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(lambda x_, a_, b_, c_: ssd_chunked(x_, a_, b_, c_, 16),
                     to_jax(x), to_jax(a)[..., 0], bm, cm)
    jdx, jda, jdb, jdc = vjp(jnp.asarray(to_jax(dy)))
    want = [np.asarray(jdx).transpose(0, 2, 1, 3).reshape(x.shape),
            np.asarray(jda).transpose(0, 2, 1).reshape(a.shape), jdb, jdc]
    for g, au, w in zip(got, auto, want):
        w = np.asarray(w)
        tol = 1e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), au.numpy(), rtol=1e-5, atol=tol)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=tol)
    # the wrapper on CPU tensors is the plain version
    again = sc.ssd_scan_bwd(_t(x), _t(a), _t(bm), _t(cm), _t(dy), 16, heads_per_bc=hpb)
    assert all(torch.equal(g, w) for g, w in zip(again, got))


def test_ssd_scan_grad_refuses_the_final_state():
    x, a, bm, cm, _ = (_t(t) for t in _ssd_inputs(1, 2, 2, 1, seed=0))
    with pytest.raises(ValueError, match="return_state"):
        sc.ssd_scan_grad(x.requires_grad_(), a, bm, cm, 16, heads_per_bc=2, return_state=True)


def test_autograd_functions_route_through_the_wrappers(monkeypatch):
    """The differentiable ops (on the card, ``ops`` picks them for CUDA
    tensors under grad) save what their backward needs, also when
    ``torch.utils.checkpoint`` recomputes them: driven on CPU tensors,
    where their wrappers are the plain versions."""
    q, k, v, do = (_t(a) for a in _attn_inputs(1, 4, 2, 20, 8, seed=1))
    scale = _t((0.1 * np.random.default_rng(2).normal(size=(8,))).astype(np.float32))

    def model(q, k, v, scale):
        h = fa.flash_attention_grad(q, k, v, True)
        return rn.rms_norm_grad(h.reshape(-1, 8), scale).reshape(h.shape)

    want_leaves = [t.clone().requires_grad_() for t in (q, k, v, scale)]
    want = torch.autograd.grad(
        rms_norm_ref(flash_attention_ref(*want_leaves[:3]).reshape(-1, 8), want_leaves[3]),
        want_leaves, do.reshape(-1, 8),
    )
    x, a, bm, cm, dy = (_t(t) for t in _ssd_inputs(2, 3, 3, 2, seed=5))

    def scan(x, a, bm, cm):
        return sc.ssd_scan_grad(x, a, bm, cm, 16, heads_per_bc=3)

    ssd_leaves = [t.clone().requires_grad_() for t in (x, a, bm, cm)]
    want_ssd = torch.autograd.grad(ssd_scan_ref(*ssd_leaves, 16, 3), ssd_leaves, dy)
    calls = {"attn": 0, "norm": 0, "ssd": 0}
    real_attn, real_norm, real_ssd = fa.flash_attention_bwd, rn.rms_norm_bwd, sc.ssd_scan_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a: calls.__setitem__("attn", calls["attn"] + 1) or real_attn(*a))
    monkeypatch.setattr(rn, "rms_norm_bwd",
                        lambda *a: calls.__setitem__("norm", calls["norm"] + 1) or real_norm(*a))
    monkeypatch.setattr(sc, "ssd_scan_bwd", lambda *a, **kw: calls.__setitem__(
        "ssd", calls["ssd"] + 1) or real_ssd(*a, **kw))
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, scale)]
        ssd_leaves = [t.clone().requires_grad_() for t in (x, a, bm, cm)]
        if remat:
            out = torch.utils.checkpoint.checkpoint(model, *leaves, use_reentrant=False)
            y = torch.utils.checkpoint.checkpoint(scan, *ssd_leaves, use_reentrant=False)
        else:
            out, y = model(*leaves), scan(*ssd_leaves)
        got = torch.autograd.grad(out, leaves, do)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        for g, w in zip(torch.autograd.grad(y, ssd_leaves, dy), want_ssd):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    assert calls == {"attn": 2, "norm": 2, "ssd": 2}


def test_ops_take_plain_versions_under_grad_on_the_cpu():
    x = torch.randn(3, 16, requires_grad=True)
    y = ops.rms_norm(x, torch.zeros(16))
    assert y.grad_fn is not None and "RmsNorm" not in type(y.grad_fn).__name__
    xs, a, bm, cm, _ = (_t(t) for t in _ssd_inputs(1, 2, 2, 1, seed=1))
    y = ops.ssd(xs.requires_grad_(), a, bm, cm, 16, heads_per_bc=2)
    assert y.grad_fn is not None and "SsdScan" not in type(y.grad_fn).__name__


# ------------------------------------------------------------- launcher


def test_train_launcher_smoke_on_cpu(capsys):
    ttrain.main(["--arch", "qwen3-14b", "--smoke", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] qwen3-14b-smoke on cpu" in out
    assert "[train] step    1 loss" in out and "gnorm" in out
    assert "[train] 2 steps in" in out


def _launcher_steps(out: str) -> list[tuple[int, float, float]]:
    return [(int(w[2]), float(w[4]), float(w[6])) for w in (ln.split() for ln in out.splitlines())
            if w[:2] == ["[train]", "step"]]


def test_train_launcher_runs_the_sharded_step_on_a_mesh(capsys):
    """``--model-parallel 2 --devices 4``: the sharded step on a (2, 2)
    mesh of CPU positions, its losses and grad norms within 1e-5 of the
    one-device launcher's."""
    args = ["--arch", "qwen3-14b", "--smoke", "--steps", "10", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    ttrain.main(args)
    one = _launcher_steps(capsys.readouterr().out)
    ttrain.main(args + ["--model-parallel", "2", "--devices", "4"])
    out = capsys.readouterr().out
    assert "[train] qwen3-14b-smoke on mesh {'data': 2, 'model': 2} over cpu" in out
    mesh = _launcher_steps(out)
    assert [s for s, *_ in mesh] == [s for s, *_ in one] == [1, 10]
    for (_, loss, gnorm), (_, want_loss, want_gnorm) in zip(mesh, one):
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (mesh, one)
        assert abs(gnorm - want_gnorm) <= 1e-5 * abs(want_gnorm), (mesh, one)
