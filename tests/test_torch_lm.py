"""The port's LM serving path against the JAX package, on the CPU.

Every architecture at its smoke size (2–5 layers, widths 12–64, f32)
runs ``forward_hidden``, ``prefill`` and four ``decode_step``s in both
packages from the same parameters (the JAX ``init_params`` carried over
by ``params_from_numpy``) and the same numpy inputs; the two
``ServingEngine``s must emit the same greedy tokens.  On the CPU every
kernel wrapper runs its plain version (K3–K5 are held against the Pallas
kernels in tests/test_torch_kernels.py and run on the card in
tests/test_torch_gpu.py).

Tolerances: logits and hidden states rtol/atol 1e-4 — two CPU BLAS
libraries, and a one-pass softmax against the JAX blockwise one, sum in
other orders; single layer functions 1e-5, the MoE layer 1e-6 (the same
products and the same order of the combine's adds); decode against
prefill 2e-3, the JAX package's own bar (tests/test_archs_smoke.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as jll
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tll
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = list_archs()
B, S = 2, 32
TOL = 1e-4
LAYER_TOL = 1e-5
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jax config, jax params, port config, port params) at smoke size."""
    jcfg = jax_get_smoke_config(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch)
    tparams = tlm.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, tcfg, tparams


def _inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cache_leaves(cache):
    """(name, array) pairs of a cache, in a fixed order."""
    if "r1" in cache:  # hybrid: RG-LRU states, then the attention layers' rings
        return [(f"{name} {key}", cache[name][key]) for name in ("r1", "r2", "tail")
                for key in ("conv", "h")] + [("k", cache["k"]), ("v", cache["v"])]
    if "k" in cache:
        return [("k", cache["k"]), ("v", cache["v"])]
    return [("conv", cache["layers"]["conv"]), ("ssm", cache["layers"]["ssm"])]


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_jax_fields(arch):
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_get_smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.dtype == getattr(torch, theirs.dtype.name)


def test_unknown_arch_raises():
    for fn in (get_config, get_smoke_config):
        with pytest.raises(KeyError, match="no-such-arch"):
            fn("no-such-arch")


def test_every_arch_of_the_jax_registry_is_ported():
    assert ARCHS == jax_list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_jax_tree(arch):
    """Same tree, shapes and dtypes as the JAX init; the draws differ, the
    scales do not."""
    jcfg, jparams, tcfg, _ = _models(arch)
    ours = tlm.init_params(tcfg, seed=0, device="cpu")
    flat_j = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
    flat_t = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                flat_t[f"{prefix}['{k}']"] = v

    walk(ours)
    assert flat_t.keys() == flat_j.keys()
    for key, a in flat_j.items():
        assert tuple(flat_t[key].shape) == a.shape, key
        assert flat_t[key].dtype == getattr(torch, a.dtype.name), key
    lm_head = ours["lm_head"]
    assert abs(float(lm_head.std()) - tcfg.d_model**-0.5) < 0.1 * tcfg.d_model**-0.5


# ------------------------------------------------------- single layers


def test_rms_norm_apply_rope_and_decode_attention_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    scale = (rng.normal(size=16) * 0.1).astype(np.float32)
    _close(tll.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jll.rms_norm(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL)
    for pos in (np.arange(6), np.stack([np.arange(6), np.arange(6) + 3])):
        _close(tll.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
               jll.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), LAYER_TOL)
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 2, 9, 16)).astype(np.float32) for _ in range(2))
    _close(tll.decode_attention(*(torch.from_numpy(t) for t in (q, kc, vc)), 5),
           jll.decode_attention(*(jnp.asarray(t) for t in (q, kc, vc)), jnp.asarray(5)),
           LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "geglu"])
def test_mlp_forward_matches_jax(kind):
    jparams = jll.init_mlp(jax.random.PRNGKey(1), 24, 40, kind, jnp.float32)
    if kind == "gelu":  # non-zero biases, so they are exercised
        jparams = {**jparams, "up_b": jnp.linspace(-1, 1, 40), "down_b": jnp.linspace(1, -1, 24)}
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    x = np.random.default_rng(2).normal(size=(3, 5, 24)).astype(np.float32)
    _close(tll.mlp_forward(tparams, torch.from_numpy(x), kind),
           jll.mlp_forward(jparams, jnp.asarray(x), kind), LAYER_TOL)


# ------------------------------------------------------------ the MoE layer


def moe_params(rng, d, f, e):
    """Router and expert leaves as numpy, at scales that spread the gates."""
    return {"router": (0.5 * rng.normal(size=(d, e))).astype(np.float32),
            "gate": (0.3 * rng.normal(size=(e, d, f))).astype(np.float32),
            "up": (0.3 * rng.normal(size=(e, d, f))).astype(np.float32),
            "down": (0.3 * rng.normal(size=(e, f, d))).astype(np.float32)}


def moe_input(rng, b, s, d, tied: bool):
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if tied:  # every odd row repeats the even one before it: exactly tied gates
        x[:, 1::2] = x[:, ::2]
    return x


# (batch, seq, d_model, d_ff, experts, top_k, capacity_factor, tied rows):
# drop-free as the smoke configs, dropping at factor 1.0, and tied gates
MOE_CASES = [
    (2, 16, 12, 10, 6, 2, 3.0, False),
    (2, 64, 12, 10, 8, 2, 1.0, False),
    (2, 64, 12, 10, 8, 2, 1.0, True),
    (1, 24, 8, 6, 8, 3, 1.25, True),
    (3, 1, 8, 6, 8, 2, 1.25, False),  # one decode token
]


@pytest.mark.parametrize("b,s,d,f,e,k,cf,tied", MOE_CASES)
def test_moe_forward_matches_jax(b, s, d, f, e, k, cf, tied):
    rng = np.random.default_rng(s + e)
    params = moe_params(rng, d, f, e)
    x = moe_input(rng, b, s, d, tied)
    want = jmoe.moe_forward({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x),
                            top_k=k, capacity_factor=cf)
    got = tmoe.moe_forward({n: torch.from_numpy(v) for n, v in params.items()},
                           torch.from_numpy(x), top_k=k, capacity_factor=cf)
    _close(got, want, 1e-6)
    _close(tmoe.moe_aux_loss(torch.from_numpy(x), torch.from_numpy(params["router"]), k),
           jmoe.moe_aux_loss(jnp.asarray(x), jnp.asarray(params["router"]), k), 1e-6)


def test_moe_drops_and_ties_are_exercised():
    """MOE_CASES' factor-1.0 inputs route more tokens to some expert than it
    has slots, so tokens drop; with tied rows the overflowing expert's
    tokens come in pairs of equal gates, so the stable selection decides."""
    cap = tmoe.moe_capacity(64, 8, 2, 1.0)
    assert cap == 16
    for tied in (False, True):
        rng = np.random.default_rng(64 + 8)  # as test_moe_forward_matches_jax draws them
        params = moe_params(rng, 12, 10, 8)
        x = moe_input(rng, 2, 64, 12, tied)
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(params["router"]), -1)
        routed = torch.zeros_like(probs).scatter(-1, tmoe._top(probs, 2)[1], 1.0)
        assert bool((routed.sum(1) > cap).any()), "no expert overflows its capacity"


def test_moe_capacity_matches_jax():
    for seq in (1, 7, 16, 128, 2048, 4096):
        for e, k in ((64, 6), (128, 2), (8, 2), (6, 2)):
            for cf in (1.0, 1.25, 4.0, 64 / 6):
                assert tmoe.moe_capacity(seq, e, k, cf) == jmoe.moe_capacity(seq, e, k, cf)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    inp = _inputs(tcfg, S, seed=1)
    want = jlm.forward_hidden(jparams, jcfg, jnp.asarray(inp), jnp.arange(S))
    got = tlm.forward_hidden(tparams, tcfg, torch.from_numpy(inp), torch.arange(S))
    assert got.shape == (B, S, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """prefill's logits and cache, then four decode steps from the
    prefill's cache (copied into a larger one), logits and cache each."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    inp = _inputs(tcfg, S, seed=2)
    jl, jc = jlm.prefill(jparams, jcfg, jnp.asarray(inp))
    tl, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(inp))
    _close(tl, jl)
    assert tc["length"] == int(jc["length"]) == S
    for (name, got), (_, want) in zip(_cache_leaves(tc), _cache_leaves(jc)):
        assert tuple(got.shape) == want.shape, name
        _close(got, want)

    steps = 4
    jc2 = jlm.init_cache(jcfg, B, S + steps)
    tc2 = tlm.init_cache(tcfg, B, S + steps, CPU)
    if "r1" in jc:  # hybrid: the rings have the window's slots in both caches
        for name in ("r1", "r2", "tail", "k", "v"):
            jc2[name] = jc[name]
            tc2[name] = jax.tree.map(torch.clone, tc[name])
    elif "k" in jc:
        for name in ("k", "v"):
            jc2[name] = jc2[name].at[:, :, :, :S].set(jc[name])
            tc2[name][:, :, :, :S] = tc[name]
    else:
        jc2["layers"] = jc["layers"]
        tc2["layers"] = {k: v.clone() for k, v in tc["layers"].items()}
    jc2["length"] = jnp.asarray(S, jnp.int32)
    tc2["length"] = S
    step_inputs = _inputs(tcfg, steps, seed=3)
    for t in range(steps):
        step_in = step_inputs[:, t:t + 1]
        jl, jc2 = jlm.decode_step(jparams, jcfg, jc2, jnp.asarray(step_in))
        tl, tc2 = tlm.decode_step(tparams, tcfg, tc2, torch.from_numpy(step_in))
        _close(tl, jl)
    assert tc2["length"] == int(jc2["length"]) == S + steps
    for (name, got), (_, want) in zip(_cache_leaves(tc2), _cache_leaves(jc2)):
        _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_logits(arch):
    """Teacher-forced decode over the prompt reproduces the prefill's last
    logits in the port (tests/test_archs_smoke.py's check, replayed)."""
    _, _, tcfg, tparams = _models(arch)
    inp = torch.from_numpy(_inputs(tcfg, S, seed=4))
    want, _ = tlm.prefill(tparams, tcfg, inp)
    cache = tlm.init_cache(tcfg, B, S, CPU)
    for t in range(S):
        logits, cache = tlm.decode_step(tparams, tcfg, cache, inp[:, t:t + 1])
    _close(logits, want.numpy(), 2e-3)


@pytest.mark.parametrize("s", [24, 40])
def test_hybrid_prefill_cache_is_the_ring_decode_reads(s):
    """S = 24 and 40 with window 16: S > window and S % window != 0.  The
    port's prefill cache, stepped once by decode_step, gives the logits of
    a teacher-forced replay of the same S + 1 tokens; the JAX package's
    prefill keeps the last 16 keys in positional order, so its step reads
    wrong keys and misses the replay."""
    jcfg, jparams, tcfg, tparams = _models("recurrentgemma-9b")
    assert tcfg.window < s and s % tcfg.window
    jcfg = dataclasses.replace(jcfg, attn_block_kv=8)  # divides 24 and 40
    inp = _inputs(tcfg, s + 1, seed=7)
    cache = tlm.init_cache(tcfg, B, s + 1, CPU)
    for t in range(s + 1):
        replay, cache = tlm.decode_step(tparams, tcfg, cache, torch.from_numpy(inp[:, t:t + 1]))
    _, tc = tlm.prefill(tparams, tcfg, torch.from_numpy(inp[:, :s]))
    rings = {name: tc[name].clone() for name in ("k", "v")}  # decode_step writes in place
    got, _ = tlm.decode_step(tparams, tcfg, tc, torch.from_numpy(inp[:, s:]))
    _close(got, replay.numpy(), 2e-3)
    _, jc = jlm.prefill(jparams, jcfg, jnp.asarray(inp[:, :s]))
    jgot, _ = jlm.decode_step(jparams, jcfg, jc, jnp.asarray(inp[:, s:]))
    assert float(np.abs(np.asarray(jgot) - replay.numpy()).max()) > 1e-2
    # the same keys and values, in the ring's slot order
    shift = s % tcfg.window
    for name in ("k", "v"):
        want = torch.from_numpy(np.array(jc[name]))
        torch.testing.assert_close(rings[name], torch.roll(want, shift, dims=3),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["musicgen-medium", "pixtral-12b"])
def test_decode_step_takes_a_strided_embedding_slice(arch):
    """The engine's prompt replay feeds ``prompts[:, t:t + 1]``, a strided
    view of the wave's embeddings, which an f32 model passes to its first
    norm as it is.  The kernel wrapper checks contiguity on the card and
    on ``meta`` (the same checks, no launch): the norm hands K5 contiguous
    rows, so the replay runs there, and on the CPU it gives the logits of
    contiguous rows."""
    _, _, tcfg, tparams = _models(arch)
    emb = torch.from_numpy(_inputs(tcfg, 5, seed=3))
    meta = tlm._tree_map(lambda t: t.to("meta"), tparams)
    cache = tlm.init_cache(tcfg, B, 8, "meta")
    strided = emb.to("meta")
    for t in range(5):
        assert not strided[:, t:t + 1].is_contiguous()
        logits, cache = tlm.decode_step(meta, tcfg, cache, strided[:, t:t + 1])
    assert logits.shape == (B, tcfg.vocab_size)
    caches = [tlm.init_cache(tcfg, B, 8, CPU) for _ in range(2)]
    for t in range(5):
        got, caches[0] = tlm.decode_step(tparams, tcfg, caches[0], emb[:, t:t + 1])
        want, caches[1] = tlm.decode_step(tparams, tcfg, caches[1], emb[:, t:t + 1].clone())
        assert torch.equal(got, want)


def test_ssd_chunk_must_divide_the_prompt():
    _, _, tcfg, tparams = _models("mamba2-2.7b")
    inp = torch.from_numpy(_inputs(tcfg, 24, seed=5))  # chunk 16 does not divide 24
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tlm.prefill(tparams, tcfg, inp)


# ------------------------------------------------------------- serving


# prompt lengths per arch: max_batch=3 makes two waves; the padded wave
# lengths fit the JAX blockwise attention (<= 32 or a multiple of it) and
# the SSD chunk (16: <= 16 or a multiple of it)
ENGINE_PROMPTS = {
    "qwen3-14b": [5, 12, 9, 20, 3],
    "mamba2-2.7b": [5, 16, 9, 32, 12],
    "deepseek-moe-16b": [5, 12, 9, 20, 3],
    "arctic-480b": [7, 3, 11, 16, 9],
    # attn_block_kv 16: the padded waves (16, then 32) are <= 16 or multiples of it
    "recurrentgemma-9b": [5, 16, 9, 32, 12],
    # attn_block_kv 32: the padded waves (12, then 20) are <= 32
    "deepseek-7b": [5, 12, 9, 20, 3],
    "starcoder2-3b": [7, 3, 11, 16, 9],
    # the modality stubs: prompts of [n, d_model] f32 embeddings
    "musicgen-medium": [5, 12, 9, 20, 3],
    "pixtral-12b": [7, 3, 11, 16, 9],
}
MAX_TOKENS = [4, 6, 3, 5, 2]


@pytest.mark.parametrize("arch", sorted(ENGINE_PROMPTS))
def test_serving_engine_matches_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    rng = np.random.default_rng(6)
    if tcfg.input_mode == "tokens":
        prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
                   for n in ENGINE_PROMPTS[arch]]
    else:
        prompts = [rng.standard_normal((n, tcfg.d_model)).astype(np.float32)
                   for n in ENGINE_PROMPTS[arch]]
    jeng = JServingEngine(jcfg, jparams, max_batch=3)
    seen = []
    teng = ServingEngine(tcfg, tparams, max_batch=3, device="cpu",
                         on_logits=lambda stage, logits: seen.append(stage))
    for uid, (p, m) in enumerate(zip(prompts, MAX_TOKENS)):
        jeng.submit(JRequest(uid, p, max_tokens=m))
        teng.submit(Request(uid, p, max_tokens=m))
    jdone = {r.uid: r for r in jeng.run()}
    tdone = {r.uid: r for r in teng.run()}
    assert tdone.keys() == jdone.keys() == set(range(len(prompts)))
    for uid, r in tdone.items():
        assert r.done and r.output_tokens == jdone[uid].output_tokens, uid
        assert 1 <= len(r.output_tokens) <= MAX_TOKENS[uid]
    for key in ("requests", "tokens", "waves"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["waves"] == 2
    # the JAX engine's keys, plus the per-wave prefill and replay seconds
    assert set(teng.stats) == set(jeng.stats) | {"prefill_s", "replay_s"}
    assert len(teng.stats["prefill_s"]) == len(teng.stats["replay_s"]) == 2
    assert all(t > 0 for t in teng.stats["prefill_s"] + teng.stats["replay_s"])
    # on_logits saw every prefill, every replayed prompt token, every decode step
    lens = ENGINE_PROMPTS[arch]
    assert seen.count("prefill") == 2
    assert seen.count("replay") == max(lens[:3]) + max(lens[3:])
    assert seen.count("decode") == sum(max(MAX_TOKENS[i:i + 3]) - 1 for i in (0, 3))


def test_serving_engine_samples_from_its_seed():
    _, _, tcfg, tparams = _models("qwen3-14b")
    outs = []
    for seed in (0, 0, 1):
        eng = ServingEngine(tcfg, tparams, max_batch=2, greedy=False, seed=seed, device="cpu")
        for uid in range(2):
            eng.submit(Request(uid, np.arange(1, 6, dtype=np.int32), max_tokens=8))
        outs.append([r.output_tokens for r in eng.run()])
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_serving_engine_without_cuda_raises(monkeypatch):
    _, _, tcfg, tparams = _models("qwen3-14b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tcfg, tparams, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(tcfg)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-2.7b", "musicgen-medium",
                                  "recurrentgemma-9b"])
def test_launch_serve_smoke_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "16", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill b=2 s=16" in out and "decoded 3x2 tokens" in out
