"""The port's training substrate (repro_torch.distributed and its checks)
against the JAX package's, on the same numpy inputs, on the CPU.

Placements: every parameter leaf's spec equals the reference's
``_leaf_spec`` for every architecture at its full config's shapes, on
five meshes, FSDP on and off; ``batch_shardings`` and ``cache_shardings``
equal the reference's ``NamedSharding``s, built in a subprocess on 8
placeholder CPU devices.  ``remesh_factors`` is integer arithmetic and
equals the reference's.  Compression: the int8 codes, scales and sums are
the reference's bits (``torch.round`` and ``jnp.round`` both round half to
even); the reference's ``compressed_psum`` runs under ``shard_map`` on 4
placeholder devices in a subprocess.  The pipeline: within 1e-5 of the
port's ``sequential_forward`` (forward and gradients, f32), which is
within 1e-5 of the reference's.  The sharded train step on qwen2-7b's
smoke config (f32) against the one-device ``make_train_step``: losses and
grad norms of three steps within 1e-5, step 1's gradients within
``||dg||/||g|| <= 1e-5`` per leaf, the state after three steps within
``||d||/||ref|| <= 1e-4`` per leaf (AdamW's first update is ``-lr·sign(g)``
per element, so f32 rounding in a gradient near 0 moves a leaf that starts
at 0, such as ``bk``, by more than it moves the gradients).  The ssm,
hybrid and moe families split the same way at four meshes; the moe
family's step 1 is also held to the JAX package's ``lm_loss`` from the
same numpy weights (``params_from_numpy``): the loss within 1e-5, each
gradient within 1e-4 of its largest magnitude (tests/test_torch_train.py's
bar between the packages).
"""

import dataclasses
import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.distributed import compression as rcomp
from repro.distributed import elastic as relastic
from repro.distributed import pipeline as rpipe
from repro.distributed import sharding as rsharding
from repro.distributed.annotate import _resolve as r_resolve
from repro.models import lm as jlm
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data.pipeline import make_global_batch
from repro_torch.distributed import annotate, compression, elastic, pipeline, sharding
from repro_torch.distributed.sharding import tree_paths
from repro_torch.distributed.spmd import (ShardedTrainStep, _put, make_sharded_train_step,
                                          shard_train_state, state_shardings)
from repro_torch.launch import compression_check, pipeline_check
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models import moe as tmoe
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, tree_leaves
from repro_torch.train.step import (abstract_train_state, init_train_state, loss_and_grads,
                                    make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLACEMENT_MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
STEP_MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x1": ((2, 1), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),  # 2 kv heads on 4: "sequence"
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def _fake_mesh(shape, axes):
    """What the reference's ``_leaf_spec`` reads of a mesh."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _norm(spec, ndim) -> tuple:
    """A spec's entries as tuples of axis names, padded to ``ndim``."""
    out = [() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec]
    return tuple(out + [()] * (ndim - len(out)))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm()) if float(b.norm()) else float((a - b).norm())


# ---------------------------------------------------------------- elastic


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("model_parallel", [None, 1, 2, 4])
def test_remesh_factors_equal_the_reference(model_parallel, multi_pod):
    for n in range(1, 513):
        assert (elastic.remesh_factors(n, model_parallel, multi_pod)
                == relastic.remesh_factors(n, model_parallel, multi_pod)), n


def test_elastic_mesh_is_a_device_list():
    mesh = elastic.elastic_mesh(8, model_parallel=2, devices="cpu")
    assert (mesh.shape, mesh.axis_names, mesh.devices) == ((4, 2), ("data", "model"), ("cpu",) * 8)
    mesh = elastic.elastic_mesh(8, model_parallel=2, multi_pod=True, devices="cpu")
    assert mesh.shape == (2, 2, 2) and mesh.axis_names == ("pod", "data", "model")


# -------------------------------------------------------------- placements


@functools.lru_cache(maxsize=None)
def _reference_param_shapes(arch):
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    paths, leaves, _ = rsharding._tree_paths(shapes)
    return [(p, tuple(v.shape)) for p, v in zip(paths, leaves)]


@pytest.mark.parametrize("mesh_name", sorted(PLACEMENT_MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_placements_equal_the_reference(arch, mesh_name):
    shape, axes = PLACEMENT_MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    want_leaves = _reference_param_shapes(arch)
    params = lm.init_params(get_config(arch), device="meta")
    got_leaves = [(p, tuple(t.shape)) for p, t in tree_paths(params)]
    assert got_leaves == want_leaves
    for fsdp in (True, False):
        fsdp_ax = "data" if (fsdp and "data" in axes) else None
        placements = dict(tree_paths(sharding.param_shardings(mesh, params, fsdp)))
        for path, leaf_shape in want_leaves:
            want = tuple(rsharding._leaf_spec(path, leaf_shape, _fake_mesh(shape, axes), fsdp_ax))
            assert placements[path].spec == want, (path, fsdp)
            assert placements[path].mesh == mesh


SPEC_ORACLE = r"""
import json, sys
import jax
from repro.configs import get_config
from repro.distributed.sharding import batch_shardings, cache_shardings, _tree_paths
from repro.launch.mesh import make_mesh
from repro.models import lm

assert jax.device_count() == 8, jax.devices()
out = {}
for shape in ((4, 2), (2, 2), (1, 1)):
    mesh = make_mesh(shape, ("data", "model"))
    rec = {"batch": {}, "cache": {}}
    for b in (8, 6, 1):
        batch = {"tokens": jax.ShapeDtypeStruct((b, 16), "int32"),
                 "labels": jax.ShapeDtypeStruct((b, 16), "int32"),
                 "embeddings": jax.ShapeDtypeStruct((b, 16, 32), "float32"),
                 "scalar": jax.ShapeDtypeStruct((), "float32")}
        sh = batch_shardings(mesh, batch)
        rec["batch"][str(b)] = {k: [list(v.shape), [e if e is None or isinstance(e, str) else list(e)
                                                    for e in sh[k].spec]] for k, v in batch.items()}
    for arch in sys.argv[2:]:
        for b, s in ((4, 64), (1, 30)):
            cache = jax.eval_shape(lambda: lm.init_cache(get_config(arch), b, s))
            paths, leaves, _ = _tree_paths(cache)
            specs = _tree_paths(cache_shardings(mesh, cache))[1]
            rec["cache"][f"{arch} {b} {s}"] = [
                [p, list(v.shape), [e if e is None or isinstance(e, str) else list(e)
                                    for e in sp.spec]]
                for p, v, sp in zip(paths, leaves, specs)]
    out["x".join(map(str, shape))] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def spec_oracle(tmp_path_factory):
    """The reference's batch and cache shardings on 8 placeholder CPU
    devices, in a subprocess (the device count is fixed at JAX's start)."""
    path = tmp_path_factory.mktemp("spec_oracle") / "specs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", SPEC_ORACLE, str(path), *list_archs()],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2", "1x1"])
def test_batch_and_cache_placements_equal_the_reference(spec_oracle, mesh_name):
    shape, axes = PLACEMENT_MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    rec = spec_oracle[mesh_name]
    for b, leaves in rec["batch"].items():
        batch = {k: torch.empty(s, device="meta") for k, (s, _) in leaves.items()}
        got = sharding.batch_shardings(mesh, batch)
        for k, (s, spec) in leaves.items():
            assert _norm(got[k].spec, len(s)) == _norm(spec, len(s)), (b, k)
    assert len(rec["cache"]) == 2 * len(list_archs())
    for case, leaves in rec["cache"].items():
        tree: dict = {}
        for path, s, _ in leaves:
            node = tree
            *parents, name = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = torch.empty(s, device="meta")
        got = dict(tree_paths(sharding.cache_shardings(mesh, tree)))
        for path, s, spec in leaves:
            assert _norm(got[path].spec, len(s)) == _norm(spec, len(s)), (case, path)


def test_port_cache_leaves_get_the_rules_by_name():
    """The port's own cache trees (``length`` a Python int) take the same
    rules: KV sequence over ``model``, batch over the data axes."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for arch in ("qwen3-14b", "mamba2-2.7b", "recurrentgemma-9b"):
        cache = lm.init_cache(get_smoke_config(arch), 4, 8, device="cpu")
        got = dict(tree_paths(sharding.cache_shardings(mesh, cache)))
        assert got["length"].spec == ()
        for path, st in got.items():
            if path.rsplit("/", 1)[-1] in ("k", "v"):
                assert st.spec == (None, ("data",), None, "model", None), (arch, path)


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2", "2x16x16"])
def test_placement_blocks_tile_every_leaf(mesh_name):
    """Each position's block is the spec's row-major block; the distinct
    blocks tile the leaf exactly once, replicas hold equal copies."""
    shape, axes = PLACEMENT_MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    pl = sharding.Placement(mesh, (("pod", "data") if "pod" in axes else "data", "model"))
    t = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    st = sharding.shard(t, pl)
    assert torch.equal(st.full(), t)
    cover = torch.zeros_like(t)
    for holders in pl.owners(st.shape).values():
        cover[pl.block(st.shape, holders[0])] += 1
        for p in holders:
            assert torch.equal(st.blocks[p], t[pl.block(st.shape, p)])
    assert torch.equal(cover, torch.ones_like(t))
    assert len({b.data_ptr() for b in st.blocks}) == mesh.size  # no two positions alias


# ---------------------------------------------------------------- annotate


@pytest.mark.parametrize("mesh_name", sorted(PLACEMENT_MESHES))
def test_annotation_resolution_equals_the_reference(mesh_name):
    shape, axes = PLACEMENT_MESHES[mesh_name]
    fake = _fake_mesh(shape, axes)
    mesh = make_mesh(shape, axes, "cpu")
    for logical in ("dp", "tp", "sp", "model", "data", "pod", "nope", None):
        for dim in (1, 2, 3, 4, 6, 16, 32, 40, 64):
            assert annotate._resolve(mesh, logical, dim) == r_resolve(fake, logical, dim)
    tp = dict(zip(axes, shape))["model"]
    for hq, hkv in ((28, 4), (40, 8), (16, 1), (4, 2), (32, 32)):
        want = "heads" if hq % tp == 0 and hkv % tp == 0 else "sequence"
        assert annotate.attention_split(hq, hkv, tp) == want


def test_constraints_are_no_ops_with_or_without_a_mesh():
    q, k, v = (torch.randn(2, h, 8, 4) for h in (4, 2, 2))
    assert annotate.constrain_qkv(q, k, v) == (q, k, v)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    annotate.set_annotation_mesh(mesh)
    try:
        assert annotate.get_annotation_mesh() is mesh
        got = annotate.constrain_qkv(q, k, v)
        assert all(a is b for a, b in zip(got, (q, k, v)))
        assert annotate.constrain_attn_out(q, 2) is q
        assert annotate.constrain(q, "dp", "tp", None, None) is q
        assert annotate.placement(mesh, (2, 4, 8, 4), "dp", "tp", None, None) == (
            "data", "model", None, None)
        with pytest.raises(ValueError):
            annotate.constrain(q, "dp", None)
    finally:
        annotate.set_annotation_mesh(None)


# ------------------------------------------------------------- compression


def test_quantize_and_feedback_are_the_reference_bits():
    rng = np.random.default_rng(0)
    for shape, scale in (((4096,), 1.0), ((33, 7), 1e-3), ((5,), 0.0)):
        g = (rng.normal(size=shape) * scale).astype(np.float32)
        err = (rng.normal(size=shape) * scale * 0.01).astype(np.float32)
        q, s = compression.quantize_int8(torch.from_numpy(g))
        rq, rs = rcomp.quantize_int8(jnp.asarray(g))
        assert np.array_equal(q.numpy(), np.asarray(rq)) and q.dtype == torch.int8
        assert np.array_equal(s.numpy(), np.asarray(rs))
        assert np.array_equal(compression.dequantize_int8(q, s).numpy(),
                              np.asarray(rcomp.dequantize_int8(rq, rs)))
        got = compression.compress_with_feedback(torch.from_numpy(g), torch.from_numpy(err))
        want = rcomp.compress_with_feedback(jnp.asarray(g), jnp.asarray(err))
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_int8_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(64):
        q, scale, err = compression.compress_with_feedback(g, err)
        total = total + compression.dequantize_int8(q, scale)
    rel = float((total / 64 - g).abs().max() / g.abs().max())
    assert rel < 1e-2, rel


PSUM_ORACLE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist.mesh import shard_map
from repro.distributed.compression import compressed_psum
from repro.launch.mesh import make_mesh

assert jax.device_count() == 4, jax.devices()
mesh = make_mesh((4,), ("data",))
z = np.load(sys.argv[1])
fn = jax.jit(shard_map(lambda g, e: compressed_psum(g, e, "data"), mesh,
                       (P("data"), P("data")), (P("data"), P("data"))))
g, err = jnp.asarray(z["grads"]), jnp.asarray(z["errs"])
outs = {}
for r in range(3):
    total, err = fn(g, err)
    outs[f"total{r}"], outs[f"err{r}"] = np.asarray(total), np.asarray(err)
np.savez(sys.argv[2], **outs)
"""


def _psum_inputs():
    rng = np.random.default_rng(3)
    grads = (rng.normal(size=(4, 1000)) * np.array([[1.0], [0.5], [2.0], [0.1]])).astype(np.float32)
    errs = (rng.normal(size=(4, 1000)) * 0.01).astype(np.float32)
    return grads, errs


def test_compressed_psum_is_the_reference_bits(tmp_path):
    grads, errs = _psum_inputs()
    np.savez(tmp_path / "in.npz", grads=grads, errs=errs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", PSUM_ORACLE, str(tmp_path / "in.npz"),
                        str(tmp_path / "out.npz")], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    gs = [torch.from_numpy(g) for g in grads]
    err = [torch.from_numpy(e) for e in errs]
    for rnd in range(3):
        total, err = compression.compressed_psum(gs, err)
        assert np.array_equal(torch.stack(total).numpy(), want[f"total{rnd}"]), rnd
        assert np.array_equal(torch.stack(err).numpy(), want[f"err{rnd}"]), rnd


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_rank(rank, world, port, grads, errs, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        err = torch.from_numpy(errs[rank])
        for rnd in range(3):
            total, err = compression.compressed_psum_group(torch.from_numpy(grads[rank]), err)
            np.save(os.path.join(out_dir, f"{rank}-{rnd}-total.npy"), total.numpy())
            np.save(os.path.join(out_dir, f"{rank}-{rnd}-err.npy"), err.numpy())
    finally:
        dist.destroy_process_group()


def test_compressed_psum_over_gloo_equals_the_mesh_form(tmp_path):
    grads, errs = _psum_inputs()
    grads, errs = grads[:2], errs[:2]
    mp.start_processes(_gloo_rank, args=(2, _free_port(), grads, errs, str(tmp_path)), nprocs=2,
                       join=True, start_method="spawn")
    gs = [torch.from_numpy(g) for g in grads]
    err = [torch.from_numpy(e) for e in errs]
    for rnd in range(3):
        total, err = compression.compressed_psum(gs, err)
        for rank in range(2):
            assert np.array_equal(np.load(tmp_path / f"{rank}-{rnd}-total.npy"), total[rank].numpy())
            assert np.array_equal(np.load(tmp_path / f"{rank}-{rnd}-err.npy"), err[rank].numpy())


def test_init_error_buffers_are_f32_zeros():
    grads = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2, 2)}}
    bufs = compression.init_error_buffers(grads)
    assert bufs["a"].dtype == torch.float32 and not bufs["a"].any()
    assert bufs["b"]["c"].shape == (2, 2)


def test_compression_check_passes_on_the_cpu(capsys):
    compression_check.main(["--devices", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("ONESHOT_RELERR") and out[-1] == "OK"


# ---------------------------------------------------------------- pipeline


def _pipe_inputs(seed=0, L=8, M=6, MB=4, D=16, F=32):
    rng = np.random.default_rng(seed)
    return ({"w1": (rng.normal(size=(L, D, F)) * 0.3).astype(np.float32),
             "w2": (rng.normal(size=(L, F, D)) * 0.3).astype(np.float32)},
            rng.normal(size=(M, MB, D)).astype(np.float32))


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_sequential(stages):
    params_np, x_np = _pipe_inputs()
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    x = torch.from_numpy(x_np)
    pipe = pipeline.make_pipeline_forward(make_mesh((stages,), ("stage",), "cpu"), "stage",
                                          pipeline_check.layer_fn)

    def run(fn):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        y = fn(leaves)
        return y.detach(), torch.autograd.grad(torch.sum(y ** 2), [leaves["w1"], leaves["w2"]])

    got, g_got = run(lambda p: pipe(p, x))
    want, g_want = run(lambda p: pipeline.sequential_forward(p, x, pipeline_check.layer_fn))
    assert float((got - want).abs().max()) < 1e-5
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max() / (b.abs().max() + 1e-9)) < 1e-5


def test_sequential_forward_matches_the_reference():
    params_np, x_np = _pipe_inputs(seed=5)

    def jlayer(lp, h):
        return h + jnp.tanh(h @ lp["w1"]) @ lp["w2"]

    want = np.asarray(rpipe.sequential_forward({k: jnp.asarray(v) for k, v in params_np.items()},
                                               jnp.asarray(x_np), jlayer))
    got = pipeline.sequential_forward({k: torch.from_numpy(v) for k, v in params_np.items()},
                                      torch.from_numpy(x_np), pipeline_check.layer_fn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_check_passes_on_the_cpu(stages, capsys):
    pipeline_check.main(["--devices", str(stages), "--stages", str(stages), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["FWD_ERR 0.000e+00", "GRAD_RELERR 0.000e+00"] and out[-1] == "OK"


def test_pipeline_rejects_layers_that_do_not_divide():
    params_np, x_np = _pipe_inputs(L=6)
    pipe = pipeline.make_pipeline_forward(make_mesh((4,), ("stage",), "cpu"), "stage",
                                          pipeline_check.layer_fn)
    with pytest.raises(ValueError, match="do not divide"):
        pipe({k: torch.from_numpy(v) for k, v in params_np.items()}, torch.from_numpy(x_np))


# --------------------------------------------------------- the sharded step


OPT = AdamWConfig(lr=1e-3)


@functools.lru_cache(maxsize=None)
def _one_device_run(arch="qwen2-7b", seq=16):
    """``arch``'s smoke config (f32; qwen2-7b's by default): the one-device
    step 1's loss and gradients, then three steps of ``make_train_step``
    from the same init: their losses and grad norms, and the state after
    them."""
    cfg = get_smoke_config(arch)
    batches = [make_global_batch(0, i, 4, seq, cfg.vocab_size, "cpu") for i in range(3)]
    state = init_train_state(cfg, OPT, seed=0, device="cpu")
    loss1, grads1 = loss_and_grads(state["params"], cfg, batches[0])
    step = make_train_step(cfg, OPT)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return cfg, batches, float(loss1), grads1, metrics, state


def _held_to_one_device(step, mesh, cfg, batches, loss1, grads1, want, want_state):
    """Step 1's loss and gradients within 1e-5 of the one-device step's,
    three steps' losses and grad norms within 1e-5, the state after them
    within 1e-4 per leaf."""
    state = shard_train_state(init_train_state(cfg, OPT, seed=0, device="cpu"), mesh)
    loss, grads = step.loss_and_grads(state["params"], batches[0])
    assert abs(float(loss) - loss1) <= 1e-5 * abs(loss1)
    for (path, g), ref in zip(tree_paths(grads), tree_leaves(grads1)):
        assert g.dtype == torch.float32 and g.placement.mesh == mesh
        assert _rel(g.full(), ref) <= 1e-5, path
    got = []
    for b in batches:
        state, m = step(state, b)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-5 * abs(wn), (got, want)
    full = sharding.unshard_tree(state)
    for (path, a), b in zip(tree_paths(full), tree_leaves(want_state)):
        assert _rel(a, b) <= 1e-4, path
    assert int(full["opt"]["step"]) == 3


@pytest.mark.parametrize("mesh_name", sorted(STEP_MESHES))
def test_sharded_step_matches_the_one_device_step(mesh_name):
    cfg, batches, loss1, grads1, want, want_state = _one_device_run()
    shape, axes = STEP_MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    step = make_sharded_train_step(cfg, OPT, mesh)
    tp = dict(zip(axes, shape))["model"]
    assert step.attention == ("whole" if tp == 1 else "sequence" if tp == 4 else "heads")
    _held_to_one_device(step, mesh, cfg, batches, loss1, grads1, want, want_state)


RECURRENT_MESHES = ("1x2", "2x1", "2x2", "1x4")
RECURRENT_SEQ = 32  # two of the smoke window's 16: the window cuts inside the second block


@pytest.mark.parametrize("mesh_name", RECURRENT_MESHES)
@pytest.mark.parametrize("arch,mixer", [("mamba2-2.7b", "heads"), ("recurrentgemma-9b", "channels")])
def test_sharded_recurrent_step_matches_the_one_device_step(arch, mixer, mesh_name):
    """The ssm and hybrid families split over ``model`` (Mamba-2 by
    heads, RG-LRU by channels, the hybrid's local attention by sequence
    and its MLPs by columns): loss, gradients and three steps within 1e-5
    of the one-device step."""
    cfg, batches, loss1, grads1, want, want_state = _one_device_run(arch, RECURRENT_SEQ)
    shape, axes = STEP_MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    step = make_sharded_train_step(cfg, OPT, mesh)
    tp = dict(zip(axes, shape))["model"]
    assert step.tensor_parallel == (tp > 1)
    assert step.mixer == (mixer if tp > 1 else "whole")
    if arch == "recurrentgemma-9b" and tp > 1:
        assert (step.attention, step.mlp) == ("sequence", "columns")
    _held_to_one_device(step, mesh, cfg, batches, loss1, grads1, want, want_state)


@pytest.mark.parametrize("tp", [2, 4])
def test_split_recurrent_kernels_see_each_positions_share(monkeypatch, tp):
    """At (1, tp): K4 runs ``H/tp`` heads a B/C row, K6 ``R/tp`` channels,
    and the hybrid's windowed attention each sequence block's rows from
    the window's first key (or 0) to the block's end."""
    seen = {"K4": [], "K6": [], "K3": []}
    real = {"K4": lm.mb.ssd_chunked, "K6": lm.rg.rglru_scan, "K3": lm.ll.blockwise_attention}

    def k4(x, a, b, c, **kw):
        seen["K4"].append((tuple(x.shape), tuple(b.shape)))
        return real["K4"](x, a, b, c, **kw)

    def k6(a, w, h0=None):
        seen["K6"].append(tuple(a.shape))
        return real["K6"](a, w, h0)

    def k3(q, k, v, **kw):
        seen["K3"].append((tuple(q.shape), tuple(k.shape), kw.get("window")))
        return real["K3"](q, k, v, **kw)

    monkeypatch.setattr(lm.mb, "ssd_chunked", k4)
    monkeypatch.setattr(lm.rg, "rglru_scan", k6)
    monkeypatch.setattr(lm.ll, "blockwise_attention", k3)
    mesh = make_mesh((1, tp), ("data", "model"), "cpu")
    s = RECURRENT_SEQ
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        batch = make_global_batch(0, 0, 4, s, cfg.vocab_size, "cpu")
        state = shard_train_state(init_train_state(cfg, OPT, seed=0, device="cpu"), mesh)
        make_sharded_train_step(cfg, OPT, mesh).loss_and_grads(state["params"], batch)
    heads = 2 * get_smoke_config("mamba2-2.7b").d_model // get_smoke_config("mamba2-2.7b").ssm_head_dim
    hd = get_smoke_config("mamba2-2.7b").ssm_head_dim
    assert set(seen["K4"]) == {((4, s, heads // tp, hd), (4, s, 16))}
    rcfg = get_smoke_config("recurrentgemma-9b")
    assert set(seen["K6"]) == {(4, s, rcfg.d_rnn // tp)}
    w, win = s // tp, rcfg.window
    want = set()
    for m in range(tp):
        first = max(0, m * w - win + 1)
        rows = (m + 1) * w - first
        want.add(((4, rcfg.num_heads, rows, rcfg.head_dim), (4, 1, rows, rcfg.head_dim), win))
    assert set(seen["K3"]) == want
    assert any(m * w - win + 1 > 0 for m in range(tp))  # the window cuts a block's keys


def _per_position_norm(self, ys, zs, norms):
    """Each position normalises its own columns alone: not the one-device
    norm over all of d_inner."""
    return [lm.ll.rms_norm(y, n) * torch.nn.functional.silu(z) for y, z, n in zip(ys, zs, norms)]


def test_mamba_gated_norm_must_combine_over_model(monkeypatch):
    """At (1, 2): the gated norm combined over the positions (the f32 sums
    of squares added) holds loss and gradients within 1e-5 of one device;
    a per-position norm misses them by far more."""
    cfg, batches, loss1, grads1, *_ = _one_device_run("mamba2-2.7b", RECURRENT_SEQ)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    state = shard_train_state(init_train_state(cfg, OPT, seed=0, device="cpu"), mesh)

    def worst():
        loss, grads = make_sharded_train_step(cfg, OPT, mesh).loss_and_grads(state["params"],
                                                                            batches[0])
        errs = [_rel(g.full(), ref) for (_, g), ref in zip(tree_paths(grads), tree_leaves(grads1))]
        return max([abs(float(loss) - loss1) / abs(loss1)] + errs)

    assert worst() <= 1e-5
    monkeypatch.setattr(ShardedTrainStep, "_gated_norm", _per_position_norm)
    assert worst() > 1e-3


def test_sharded_step_splits_heads_and_columns_over_model(monkeypatch):
    """At (2, 2) each model position's attention runs half the heads and
    its MLP half the columns: the per-position config and the shapes
    reaching attention and the down projection."""
    cfg, batches, *_ = _one_device_run()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    step = make_sharded_train_step(cfg, OPT, mesh)
    assert (step.local.num_heads, step.local.num_kv_heads, step.local.d_ff) == (2, 1, 56)
    seen = []
    real = lm.ll.blockwise_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(lm.ll, "blockwise_attention", spy)
    state = shard_train_state(init_train_state(cfg, OPT, seed=0, device="cpu"), mesh)
    step.loss_and_grads(state["params"], batches[0])
    assert seen and set(seen) == {((2, 2, 16, 14), (2, 1, 16, 14))}


def test_sharded_step_stores_only_each_positions_blocks():
    cfg = get_smoke_config("qwen2-7b")
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    one = init_train_state(cfg, OPT, seed=0, device="cpu")
    state = shard_train_state(one, mesh)
    wq = state["params"]["blocks"]["attn"]["wq"]
    assert wq.placement.spec == (None, "data", "model")
    assert all(tuple(b.shape) == (2, 14, 28) for b in wq.blocks)
    assert state["opt"]["step"].placement.spec == ()
    placements = state_shardings(mesh, one)
    assert placements["opt"]["m"]["blocks"]["attn"]["wq"].spec == wq.placement.spec


def test_other_families_train_whole_on_each_data_shard():
    """At (2, 2): deepseek-moe splits its experts over ``model``, its
    attention by heads and its MLPs (the dense block's, the shared
    experts') by columns; mamba2 splits its mixer by heads (no attention,
    no MLP).  Both within 1e-5 of one device."""
    for arch, mixer in (("deepseek-moe-16b", "whole"), ("mamba2-2.7b", "heads")):
        cfg = get_smoke_config(arch)
        batch = make_global_batch(0, 0, 4, 16, cfg.vocab_size, "cpu")
        state = init_train_state(cfg, OPT, seed=0, device="cpu")
        loss1, grads1 = loss_and_grads(state["params"], cfg, batch)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        step = make_sharded_train_step(cfg, OPT, mesh)
        moe = arch.startswith("deepseek")
        assert (step.attention, step.mlp) == (("heads", "columns") if moe else ("whole", "whole"))
        assert step.tensor_parallel and step.mixer == mixer
        assert step.experts == ("experts" if moe else "whole")
        loss, grads = step.loss_and_grads(shard_train_state(state, mesh)["params"], batch)
        assert abs(float(loss) - float(loss1)) <= 1e-5 * abs(float(loss1))
        for (path, g), ref in zip(tree_paths(grads), tree_leaves(grads1)):
            assert _rel(g.full(), ref) <= 1e-5, (arch, path)


# ------------------------------------------------- the moe family's experts

MOE_ARCHS = ("deepseek-moe-16b", "arctic-480b")


@functools.lru_cache(maxsize=None)
def _jax_moe_step1(arch):
    """The JAX package's ``lm_loss`` and its gradients at the port's
    initial parameters (as numpy arrays) on ``_one_device_run``'s first
    batch: (numpy parameters, loss, gradient leaves)."""
    cfg, batches, *_ = _one_device_run(arch)
    np_params = sharding.tree_map(lambda t: t.numpy(),
                                  init_train_state(cfg, OPT, seed=0, device="cpu")["params"])
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batches[0].items()}
    loss, grads = jax.value_and_grad(jlm.lm_loss)(jax.tree.map(jnp.asarray, np_params),
                                                  jax_get_smoke_config(arch), jbatch)
    return np_params, float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("mesh_name", RECURRENT_MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_step_matches_the_one_device_step(arch, mesh_name):
    """The moe family split over ``model``: each position its ``E/tp``
    experts, attention by heads (arctic's 2 KV heads by query rows at tp
    4), the leading dense block's MLP, the shared experts and the dense
    residual by columns.  Loss, gradients and three steps within 1e-5 of
    the one-device step; step 1 from the JAX package's weights
    (``params_from_numpy``) within 1e-5 of its ``lm_loss``, each gradient
    within 1e-4 of its largest magnitude (tests/test_torch_train.py's
    bar between the packages)."""
    cfg, batches, loss1, grads1, want, want_state = _one_device_run(arch)
    shape, axes = STEP_MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "cpu")
    step = make_sharded_train_step(cfg, OPT, mesh)
    tp = dict(zip(axes, shape))["model"]
    assert step.tensor_parallel == (tp > 1)
    assert step.experts == ("experts" if tp > 1 else "whole")
    if tp > 1:
        assert step.mlp == "columns"
        assert step.attention == ("sequence" if (arch, tp) == ("arctic-480b", 4) else "heads")
    _held_to_one_device(step, mesh, cfg, batches, loss1, grads1, want, want_state)
    np_params, jloss, jgrads = _jax_moe_step1(arch)
    params = lm.params_from_numpy(cfg, np_params, "cpu")
    loss, grads = step.loss_and_grads(sharding.shard_tree(params, sharding.param_shardings(
        mesh, params)), batches[0])
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    for (path, g), w in zip(tree_paths(grads), jgrads):
        assert g.shape == w.shape, path
        assert float((g.full() - torch.from_numpy(w.copy())).abs().max()) <= 1e-4 * float(
            np.abs(w).max()) + 1e-12, path


def _layer_shares(step, layer: dict) -> list[dict]:
    """Each model position's share of one layer's whole leaves, sliced as
    ``step._share`` splits them (attention by heads)."""
    out: list[dict] = [{} for _ in range(step.tp)]
    for path, t in tree_paths(layer):
        ms, dim = step._share(path, "heads", step.mlp)
        for m in ms:
            _put(out[m], path, t[step._region(tuple(t.shape), dim, m)])
    return out


def test_moe_split_routes_as_one_device_and_runs_each_positions_experts(monkeypatch):
    """One moe block's FFN at (2, 2) on the same normed rows, each data
    shard on its rows: the routing (``fwd``, ``slot_gate``) is bitwise the
    one-device layer's; each model position's expert products
    see ``E/tp`` experts, its columns of the slot maps and gates, and the
    inverse map over its own experts; output and every gradient (``h``,
    the router, the experts, the shared experts) within 1e-5."""
    cfg = get_smoke_config("deepseek-moe-16b")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    step = make_sharded_train_step(cfg, OPT, mesh)
    layer = lm.layer(lm.init_params(cfg, seed=0, device="cpu")["moe_blocks"], 0)
    lp = {k: v for k, v in layer.items() if k in ("moe", "shared", "residual")}
    h = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 16, cfg.d_model))
                         .astype(np.float32))
    routes, experts, einsums = [], [], []
    real_route, real_experts, real_einsum = tmoe.moe_route, tmoe.moe_experts, torch.einsum

    def route(*args, **kw):
        out = real_route(*args, **kw)
        routes.append([t.detach().clone() for t in out])
        return out

    def spy_experts(gate, up, down, x, fwd, inv, slot_gate):
        experts.append((gate.shape[0], fwd.clone(), inv.clone(), slot_gate.detach().clone()))
        return real_experts(gate, up, down, x, fwd, inv, slot_gate)

    def einsum(eq, *ops):
        einsums.append((eq, ops[1].shape[0]))
        return real_einsum(eq, *ops)

    monkeypatch.setattr(tmoe, "moe_route", route)
    monkeypatch.setattr("repro_torch.distributed.spmd.moe_route", route)
    monkeypatch.setattr("repro_torch.distributed.spmd.moe_experts", spy_experts)
    monkeypatch.setattr(torch, "einsum", einsum)

    def run(fn, trees, x):
        leaves = [[t.requires_grad_() for _, t in tree_paths(tree)] for tree in trees]
        y = fn(x.requires_grad_())
        grads = torch.autograd.grad((y * y).sum(), [x] + sum(leaves, []))
        out, k = [], 1
        for tree, ls in zip(trees, leaves):
            out.append(dict(zip([p for p, _ in tree_paths(tree)], grads[k:k + len(ls)])))
            k += len(ls)
        return y, grads[0], out

    one = sharding.tree_map(lambda t: t.detach().clone(), lp)
    y1, gh1, (g1,) = run(lambda x: lm._moe_ffn(one, cfg, x), [one], h.clone())
    (want,) = routes
    assert {n for _, n in einsums} == {cfg.num_experts}
    e = cfg.num_experts // 2
    ys, ghs, got = [], [], {}
    routes.clear()
    einsums.clear()
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        lps = [sharding.tree_map(lambda t: t.detach().clone(), v)
               for v in _layer_shares(step, lp)]
        devices = [step.devices[int(p)] for p in step.rows[i]]
        y, gh, gs = run(lambda x: step._moe(lps, x, devices, step.mlp), lps, h[rows].clone())
        ys.append(y.detach())
        ghs.append(gh)
        fwd, gate = routes[i]
        for w, t in zip(want, (fwd, gate)):
            assert torch.equal(w[rows], t)  # the routing, bitwise
        for m, (n, fwd_m, inv_m, gate_m) in enumerate(experts[2 * i:2 * i + 2]):
            cols = slice(m * e, (m + 1) * e)
            assert n == e
            assert torch.equal(fwd_m, fwd.reshape(2, cfg.num_experts, -1)[:, cols].reshape(2, -1))
            assert torch.equal(gate_m, gate[:, cols])
            assert torch.equal(inv_m, tmoe.slot_inverse(fwd_m, 16, cfg.top_k))
        for path, ref in g1.items():  # each leaf's gradient, the positions' shares put back
            ms, dim = step._share(path, "heads", step.mlp)
            whole = torch.zeros_like(ref)
            for m in ms:
                whole[step._region(tuple(ref.shape), dim, m)] = gs[m][path]
            got[path] = whole if i == 0 else got[path] + whole
    assert {n for _, n in einsums} == {e}
    assert {p.split("/")[0] for p in g1} >= {"moe", "shared"}
    assert _rel(torch.cat(ys), y1.detach()) <= 1e-5 and _rel(torch.cat(ghs), gh1) <= 1e-5
    for path, ref in g1.items():
        assert _rel(got[path], ref) <= 1e-5, path


def test_moe_whose_experts_do_not_divide_trains_whole():
    """deepseek-moe's smoke config with 6 experts on (1, 4): the experts do
    not divide, so the family runs whole at the first position (no
    attention or MLP split either), within 1e-5 of one device."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), num_experts=6,
                              capacity_factor=3.0)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    step = make_sharded_train_step(cfg, OPT, mesh)
    assert (step.experts, step.tensor_parallel, step.attention, step.mlp) == (
        "whole", False, "whole", "whole")
    batch = make_global_batch(0, 0, 4, 16, cfg.vocab_size, "cpu")
    state = init_train_state(cfg, OPT, seed=0, device="cpu")
    loss1, grads1 = loss_and_grads(state["params"], cfg, batch)
    loss, grads = step.loss_and_grads(shard_train_state(state, mesh)["params"], batch)
    assert abs(float(loss) - float(loss1)) <= 1e-5 * abs(float(loss1))
    for (path, g), ref in zip(tree_paths(grads), tree_leaves(grads1)):
        assert _rel(g.full(), ref) <= 1e-5, path


def test_elastic_remesh_subprocess(tmp_path):
    """Train on (4, 2), checkpoint, resume on (2, 2): the loss continues
    (the reference's check fails; the port's passes)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.elastic_check", "--devices", "8",
                        "--ckpt", str(tmp_path), "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, f"\nstdout:{r.stdout}\nstderr:{r.stderr[-2000:]}"
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "OK" and lines[-2].startswith("LOSS3 8dev=")


def test_restore_puts_each_leaf_into_its_blocks(tmp_path):
    """A one-device state (bf16 parameters, f32 moments, a 0-d step)
    restored through ``shardings=`` onto (2, 2): every block bitwise its
    region of the saved leaf."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), dtype_name="bfloat16")
    state = init_train_state(cfg, OPT, seed=0, device="cpu")
    state, _ = make_train_step(cfg, OPT)(state, make_global_batch(0, 0, 2, 8, cfg.vocab_size, "cpu"))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    like = abstract_train_state(cfg, OPT)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    restored, at = mgr.restore(like, shardings=state_shardings(mesh, like))
    assert at == 1
    for (path, st), want in zip(tree_paths(restored), tree_leaves(state)):
        assert st.dtype == want.dtype and st.shape == tuple(want.shape), path
        for p, block in enumerate(st.blocks):
            assert torch.equal(block, want[st.placement.block(st.shape, p)]), (path, p)
    # and a sharded state saves as its whole leaves
    mgr.save(2, restored)
    again, _ = mgr.restore(like)
    for a, b in zip(tree_leaves(again), tree_leaves(state)):
        assert torch.equal(a, b)


def test_reshard_moves_a_sharded_state_between_meshes():
    cfg = get_smoke_config("qwen2-7b")
    one = init_train_state(cfg, OPT, seed=0, device="cpu")
    big = shard_train_state(one, make_mesh((4, 2), ("data", "model"), "cpu"))
    small = make_mesh((2, 2), ("data", "model"), "cpu")
    moved = elastic.reshard(big, state_shardings(small, one))
    for (path, st), want in zip(tree_paths(moved), tree_leaves(one)):
        assert st.placement.mesh == small and torch.equal(st.full(), want), path
