"""The port's sharded serving step (``repro_torch.distributed.spmd``:
``ShardedServeStep``, ``make_sharded_serve_prefill``/``make_sharded_serve_step``)
against the port's one-device step and the JAX package's
``make_serve_prefill``/``make_serve_step``, on the CPU.

The smoke configs (f32) at the same numpy parameters (drawn by the
port's ``init_params`` with the JAX package's distributions, given to the
JAX package as arrays and to the port by ``params_from_numpy``; the JAX
draw would take ~15 s of this file's budget), a global batch of
4 prompts of 12 tokens, then 8 greedy decode steps from a cache of 32
slots: on ``model`` positions of 16 slots (tp 2) or 8 (tp 4) the steps at
12–15 meet a block with no valid key yet and the step at 16 crosses into
it.  Both packages and the sharded step take the same tokens (the JAX
package's greedy choice), and each must choose them too.

Tolerances: logits 1e-5 relative (``||a - b|| / ||b||``) against both
references, as ``tests/test_torch_distributed.py`` holds the sharded
train step; cache blocks 1e-5 relative against their region of the
one-device cache (exact zeros where it is zero).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (cache_shardings, param_shardings, shard_tree,
                                              tree_map, tree_paths)
from repro_torch.distributed.spmd import (ShardedServeStep, cache_placements,
                                          make_sharded_serve_prefill, make_sharded_serve_step,
                                          shard_cache)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.perf import hlo_cost
from repro_torch.train.step import make_serve_prefill, make_serve_step

B, S, MAX_LEN, STEPS = 4, 12, 32, 8
TOL = 1e-5
CPU = torch.device("cpu")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(np.array(t, dtype=np.float64)) for t in (a, b))
    nb = float(b.norm())
    return float((a - b).norm() / nb) if nb else float((a - b).norm())


def _cache(tree) -> dict:
    return {k: v for k, v in tree.items() if k != "length"}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX package's prefill and 8 greedy decode steps, and the port's
    one-device ones fed the same tokens: (config, port parameters, prompt,
    tokens fed, JAX logits, one-device logits, one-device caches after
    prefill and after the last step)."""
    jcfg, cfg = jax_get_smoke_config(arch), get_smoke_config(arch)
    np_params = tree_map(lambda t: t.numpy(), lm.init_params(cfg, seed=0, device=CPU))
    params = lm.params_from_numpy(cfg, np_params, CPU)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    jl, jc = jax.jit(jstep.make_serve_prefill(jcfg))(jax.tree.map(jnp.asarray, np_params),
                                                     {"tokens": jnp.asarray(prompt)})
    jcache = jlm.init_cache(jcfg, B, MAX_LEN)
    if "k" in jc:  # the hybrid's ring too: S < window, position p in slot p
        jcache["k"] = jcache["k"].at[:, :, :, :S].set(jc["k"])
        jcache["v"] = jcache["v"].at[:, :, :, :S].set(jc["v"])
    for name in ("layers", "r1", "r2", "tail"):
        if name in jc:
            jcache[name] = jc[name]
    jcache["length"] = jnp.asarray(S, jnp.int32)
    jdecode = jax.jit(jstep.make_serve_step(jcfg))
    jlogits, tokens = [np.asarray(jl)], [np.asarray(jl).argmax(-1)[:, None].astype(np.int32)]
    for _ in range(STEPS):
        out, jcache = jdecode(jax.tree.map(jnp.asarray, np_params), jcache,
                              {"tokens": jnp.asarray(tokens[-1])})
        jlogits.append(np.asarray(out))
        tokens.append(np.asarray(out).argmax(-1)[:, None].astype(np.int32))

    tl, tc = make_serve_prefill(cfg)(params, {"tokens": torch.from_numpy(prompt)})
    one = _long_cache(cfg, tc)
    decode = make_serve_step(cfg)
    tlogits = [tl]
    for t in tokens[:STEPS]:
        out, one = decode(params, one, {"tokens": torch.from_numpy(t)})
        tlogits.append(out)
    return cfg, params, prompt, tokens, jlogits, tlogits, tc, one


def _long_cache(cfg, prefilled: dict) -> dict:
    """The prefill's cache written into a one-device cache of MAX_LEN slots
    (the hybrid's ring of min(window, MAX_LEN), its first S slots)."""
    cache = lm.init_cache(cfg, B, MAX_LEN, CPU)
    if "k" in cache:
        cache["k"][:, :, :, :S] = prefilled["k"]
        cache["v"][:, :, :, :S] = prefilled["v"]
    for name in ("layers", "r1", "r2", "tail"):
        if name in cache:
            cache[name] = {k: v.clone() for k, v in prefilled[name].items()}
    cache["length"] = S
    return cache


def _blocks_match(sharded: dict, whole: dict) -> None:
    want = dict(tree_paths(_cache(whole)))
    assert sorted(want) == sorted(path for path, _ in tree_paths(_cache(sharded)))
    for path, st in tree_paths(_cache(sharded)):
        t = want[path]
        assert st.shape == tuple(t.shape), path
        for p, block in enumerate(st.blocks):
            assert torch.isfinite(block).all(), (path, p)
            assert _rel(block, t[st.placement.block(st.shape, p)]) <= TOL, (path, p)
    assert sharded["length"] == whole["length"]


def _run(arch, shape):
    """The sharded prefill and decode on ``shape`` over ``"cpu"``
    positions, held to both references step by step."""
    cfg, params, prompt, tokens, jlogits, tlogits, prefilled, final = _reference(arch)
    mesh = make_mesh(shape, ("data", "model"), ["cpu"] * (shape[0] * shape[1]))
    sharded = shard_tree(params, param_shardings(mesh, params))
    prefill = make_sharded_serve_prefill(cfg, mesh)
    logits, cache = prefill(sharded, {"tokens": torch.from_numpy(prompt)})
    assert logits.shape == (B, cfg.vocab_size) and logits.dtype == torch.float32
    assert _rel(logits, tlogits[0]) <= TOL and _rel(logits, jlogits[0]) <= TOL
    assert np.array_equal(logits.argmax(-1).numpy()[:, None], tokens[0])
    _blocks_match(cache, prefilled)

    cache = shard_cache(_long_cache(cfg, prefilled), mesh)
    decode = make_sharded_serve_step(cfg, mesh)
    for i in range(STEPS):
        logits, cache = decode(sharded, cache, {"tokens": torch.from_numpy(tokens[i])})
        assert torch.isfinite(logits).all(), i
        assert _rel(logits, tlogits[i + 1]) <= TOL, (i, _rel(logits, tlogits[i + 1]))
        assert _rel(logits, jlogits[i + 1]) <= TOL, (i, _rel(logits, jlogits[i + 1]))
        assert np.array_equal(logits.argmax(-1).numpy()[:, None], tokens[i + 1]), i
    _blocks_match(cache, final)
    return ShardedServeStep(cfg, mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_qwen2_sharded_serving_matches_both_references(mesh_name):
    step = _run("qwen2-7b", MESHES[mesh_name])
    tp = MESHES[mesh_name][1]
    assert step.attention == ("whole" if tp == 1 else "sequence" if tp == 4 else "heads")
    if tp > 1:  # a block's first slot, and the steps before it, lie inside the 8 steps
        assert any(S < j * MAX_LEN // tp < S + STEPS for j in range(1, tp))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-2.7b"])
def test_other_families_serve_whole_on_each_data_shard(arch):
    """deepseek-moe splits its experts over ``model``, its attention by
    heads and its MLPs by columns; mamba2 splits its mixer by heads over
    ``model`` (no attention, no MLP)."""
    step = _run(arch, (2, 2))
    moe = arch == "deepseek-moe-16b"
    assert (step.attention, step.mlp) == (("heads", "columns") if moe else ("whole", "whole"))
    assert step.tensor_parallel and step.mixer == ("whole" if moe else "heads")
    assert step.experts == ("experts" if moe else "whole")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "arctic-480b"])
def test_moe_sharded_serving_matches_both_references(arch, mesh_name):
    """The moe family served split over ``model``: each position its
    ``E/tp`` experts (capacity 1 in a decode step), attention by heads
    (arctic's 2 KV heads by query rows at tp 4), the MLPs by columns;
    prefill and 8 greedy decode steps within 1e-5 of the one-device step
    and the JAX package."""
    step = _run(arch, MESHES[mesh_name])
    tp = MESHES[mesh_name][1]
    assert step.experts == ("experts" if tp > 1 else "whole")
    if tp > 1:
        assert step.mlp == "columns"
        assert step.attention == ("sequence" if (arch, tp) == ("arctic-480b", 4) else "heads")


def test_moe_decode_writes_each_layer_into_its_cache_layer():
    """At (1, 2) deepseek-moe's leading dense block owns cache layer 0 and
    its moe block ``i`` layer ``first_k_dense + i``: after one split decode
    step the written slot of every layer equals the one-device step's,
    and no two layers' slots hold the same keys."""
    cfg, params, prompt, tokens, _, _, prefilled, final = _reference("deepseek-moe-16b")
    assert cfg.first_k_dense == 1 and cfg.num_layers == 3
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu"] * 2)
    cache = shard_cache(_long_cache(cfg, prefilled), mesh)
    step = ShardedServeStep(cfg, mesh)
    step.decode(shard_tree(params, param_shardings(mesh, params)), cache,
                {"tokens": torch.from_numpy(tokens[0])})
    for name in ("k", "v"):
        got, want = cache[name].full()[:, :, :, S], final[name][:, :, :, S]
        for layer in range(cfg.num_layers):
            assert _rel(got[layer], want[layer]) <= TOL, (name, layer)
            assert float(got[layer].abs().max()) > 0, (name, layer)
        for a in range(cfg.num_layers):
            for b in range(a):
                assert not torch.allclose(got[a], got[b]), (name, a, b)


def _six_experts():
    """deepseek-moe's smoke config with 6 experts (drop-free at top-2):
    they do not divide tp 4."""
    return dataclasses.replace(get_smoke_config("deepseek-moe-16b"), num_experts=6,
                               capacity_factor=3.0)


def test_moe_whose_experts_do_not_divide_serves_whole(monkeypatch):
    """6 experts on (1, 4): the family runs whole, decode through
    ``_decode_whole`` (the one-device step on the first position), its
    logits within 1e-5 of one device's over 4 greedy steps."""
    cfg = _six_experts()
    params = lm.init_params(cfg, seed=0, device=CPU)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)))
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    step = ShardedServeStep(cfg, mesh)
    assert (step.experts, step.tensor_parallel, step.attention) == ("whole", False, "whole")
    calls = []
    real = ShardedServeStep._decode_whole

    def spy(self, *args):
        calls.append(1)
        return real(self, *args)

    monkeypatch.setattr(ShardedServeStep, "_decode_whole", spy)
    sharded = shard_tree(params, param_shardings(mesh, params))
    logits, _ = step.prefill(sharded, {"tokens": prompt})
    tl, tc = make_serve_prefill(cfg)(params, {"tokens": prompt})
    assert _rel(logits, tl) <= TOL
    one = _long_cache(cfg, tc)
    cache = shard_cache(_long_cache(cfg, tc), mesh)
    token = tl.argmax(-1)[:, None]
    for i in range(4):
        want, one = make_serve_step(cfg)(params, one, {"tokens": token})
        logits, cache = step.decode(sharded, cache, {"tokens": token})
        assert _rel(logits, want) <= TOL, i
        token = want.argmax(-1)[:, None]
    assert len(calls) == 4


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,mixer", [("mamba2-2.7b", "heads"), ("recurrentgemma-9b", "channels")])
def test_recurrent_sharded_serving_matches_both_references(arch, mixer, mesh_name):
    """The ssm and hybrid families served split over ``model``: prefill
    and 8 greedy decode steps within 1e-5 of the one-device step and the
    JAX package.  The hybrid's ring of 16 slots splits 8 or 4 a position;
    the steps at 12-19 wrap from the last block into the first at 16."""
    step = _run(arch, MESHES[mesh_name])
    tp = MESHES[mesh_name][1]
    assert step.mixer == (mixer if tp > 1 else "whole")
    if arch == "recurrentgemma-9b":
        ring = min(get_smoke_config(arch).window, MAX_LEN)
        assert ring == 16 and S < ring < S + STEPS
        if tp > 1:
            assert step.attention == "sequence"


def test_prefill_splits_heads_and_hands_the_cache_to_sequence_blocks(monkeypatch):
    """At (2, 2): K3 on each model position's heads for its data shard's
    rows; the cache comes back split by sequence, every block on its
    position's device."""
    cfg, params, prompt, *_ = _reference("qwen2-7b")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    seen = []
    real = lm.ll.blockwise_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(lm.ll, "blockwise_attention", spy)
    step = ShardedServeStep(cfg, mesh)
    assert step.modes(S) == ("heads", "columns")
    _, cache = step.prefill(shard_tree(params, param_shardings(mesh, params)),
                            {"tokens": torch.from_numpy(prompt)})
    assert seen and set(seen) == {((2, 2, S, 14), (2, 1, S, 14))}
    assert len(seen) == cfg.num_layers * 2 * 2
    k = cache["k"]
    assert k.placement.spec == (None, ("data",), None, "model", None)
    assert all(tuple(b.shape) == (cfg.num_layers, 2, 2, S // 2, 14) for b in k.blocks)


def _decode_copies(arch, max_len, shape=(2, 2)):
    """The collective bytes, by kind, noted by one decode step on
    ``shape`` (default (2, 2)) from a cache of ``max_len`` slots filled to
    S; ``arch`` an architecture's name or a config (its own parameters)."""
    if isinstance(arch, str):
        cfg, params, prompt, tokens, *_ = _reference(arch)
        token = torch.from_numpy(tokens[0])
    else:
        cfg, params = arch, lm.init_params(arch, seed=0, device=CPU)
        token = torch.zeros((B, 1), dtype=torch.int32)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cache = lm.init_cache(cfg, B, max_len, CPU)
    cache["length"] = S
    step = ShardedServeStep(cfg, mesh)
    params = shard_tree(params, param_shardings(mesh, params))
    _, records = hlo_cost.trace_ops(step.decode, params, shard_cache(cache, mesh),
                                    {"tokens": token})
    return hlo_cost.analyze(records)["collectives"]


def test_split_decode_never_gathers_the_cache(monkeypatch):
    """The split families' decode moves the same bytes at any cache length
    (queries, the new keys and values, softmax statistics and partial
    outputs, the gated norm's sums, the parameters' gather): no block of
    the cache crosses positions.  qwen2's cache of 32 or 128 slots, the
    hybrid's ring of 8 or 16; and for mamba2 and the hybrid no cache
    tensor is gathered (``_view``) and every block is updated where it
    lies.  deepseek-moe's split decode moves the same bytes at either
    length; a moe config whose experts do not divide ``tp`` runs whole on
    each data shard and gathers its cache: its bytes grow with the cache."""
    short, long = _decode_copies("qwen2-7b", MAX_LEN), _decode_copies("qwen2-7b", 4 * MAX_LEN)
    assert short == long and short["all-reduce"] > 0 and short["reduce-scatter"] > 0
    short, long = _decode_copies("recurrentgemma-9b", 8), _decode_copies("recurrentgemma-9b",
                                                                          MAX_LEN)
    assert short == long and short["all-reduce"] > 0 and short["reduce-scatter"] > 0
    viewed = []
    real = ShardedServeStep._view

    def spy(self, st, *args, **kw):
        viewed.append(id(st))
        return real(self, st, *args, **kw)

    monkeypatch.setattr(ShardedServeStep, "_view", spy)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg, params, prompt, tokens, _, _, prefilled, _ = _reference(arch)
        cache = shard_cache(_long_cache(cfg, prefilled), mesh)
        before = {path: [(id(b), b.data_ptr(), b.clone()) for b in st.blocks]
                  for path, st in tree_paths(_cache(cache))}
        viewed.clear()
        ShardedServeStep(cfg, mesh).decode(shard_tree(params, param_shardings(mesh, params)),
                                           cache, {"tokens": torch.from_numpy(tokens[0])})
        ids = {id(st) for _, st in tree_paths(_cache(cache))}
        assert viewed and not ids & set(viewed), arch
        for path, st in tree_paths(_cache(cache)):
            assert [(id(b), b.data_ptr()) for b in st.blocks] == [x[:2] for x in before[path]]
            if path.rsplit("/", 1)[-1] != "k" and path.rsplit("/", 1)[-1] != "v":
                assert all(not torch.equal(b, x[2]) for b, x in zip(st.blocks, before[path])), path
    short, long = (_decode_copies("deepseek-moe-16b", n) for n in (MAX_LEN, 4 * MAX_LEN))
    assert short == long and short["all-reduce"] > 0 and short["reduce-scatter"] > 0
    cfg = _six_experts()  # the experts do not divide tp 4: served whole, its cache gathered
    short, long = (_decode_copies(cfg, n, (1, 4)) for n in (MAX_LEN, 4 * MAX_LEN))
    assert long["all-gather"] - short["all-gather"] > 0


def test_shard_cache_places_every_tensor_by_cache_shardings():
    for arch in ("qwen2-7b", "mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        cache = lm.init_cache(cfg, B, MAX_LEN, CPU)
        cache["length"] = 5
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        placements = cache_placements(mesh, cache)
        want = cache_shardings(mesh, cache)
        assert "length" not in placements
        for (path, pl), (wpath, wpl) in zip(tree_paths(placements), tree_paths(_cache(want))):
            assert path == wpath and pl == wpl
        sharded = shard_cache(cache, mesh)
        assert sharded["length"] == 5
        _blocks_match(sharded, cache)
