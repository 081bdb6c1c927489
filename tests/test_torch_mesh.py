"""The port's GNN device mesh (repro_torch.dist.mesh, repro_torch.launch.mesh,
repro_torch.launch.dryrun_gnn) against the JAX package's, on the same
numpy inputs, on the CPU.

The plans are host numpy and compare with ``np.array_equal`` (``reuse``
with ``==``).  The layer steps run on meshes of ``"cpu"`` positions, K1
and K2 through their plain versions: on ``exact`` graphs (power-of-four
degrees, small-integer features and weights, every sum exact in any
order) both steps give the dense reference's bits over all padded rows;
on a power-law graph they hold to the reference's steps, run in a
subprocess on 8 placeholder CPU devices, within 1e-5 in f32 and 2e-2 in
bf16 (the reference rounds each message ``feats[src]·w`` to bf16 before
its f32 sum; K1 multiplies in f32).  The reference's dry-run and its
example rewrite ``XLA_FLAGS`` or re-exec the interpreter, so they run
only as subprocesses.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist import mesh as rmesh
from repro.graphs.synth import powerlaw_graph as r_powerlaw
from repro_torch import exact
from repro_torch.dist import mesh as tmesh
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.synth import powerlaw_graph
from repro_torch.launch import dryrun_gnn
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.gnn import dense_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x1": ((2, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
PLAN_FIELDS = {
    "edge": ("num_shards", "v_local", "bucket", "src_local", "weight", "dst_local"),
    "combined": ("num_shards", "v_local", "bucket", "slots", "src_local", "weight",
                 "edge_slot", "slot_dst", "reuse"),
}


def _cpu_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices="cpu")


# --------------------------------------------------------------- plans


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("graph", ["powerlaw", "exact"])
def test_plans_equal_the_reference(graph, kind, shards):
    if graph == "powerlaw":
        csr = powerlaw_graph(900, 6, seed=shards)
        rcsr = r_powerlaw(900, 6, seed=shards)
        assert np.array_equal(csr.indptr, rcsr.indptr)
        assert np.array_equal(csr.indices, rcsr.indices)
    else:
        csr = rcsr = exact.exact_graph_and_specs(1001, 8, kind=kind)[0]
    for build, fields in (("build_edge_plan", PLAN_FIELDS["edge"]),
                          ("build_combined_plan", PLAN_FIELDS["combined"])):
        want = getattr(rmesh, build)(rcsr, shards, kind)
        got = getattr(tmesh, build)(csr, shards, kind)
        for field in fields:
            a, b = getattr(want, field), getattr(got, field)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field
            else:
                assert a == b, field
    feats = np.arange(csr.num_vertices * 3, dtype=np.float32).reshape(-1, 3)
    assert np.array_equal(tmesh.pad_features(feats, got), rmesh.pad_features(feats, want))


@settings(max_examples=10, deadline=None)
@given(
    v=st.integers(16, 200),
    shards=st.sampled_from([2, 4]),
    seed=st.integers(0, 100),
)
def test_edge_plan_accounts_every_edge(v, shards, seed):
    """Both plans carry every edge exactly once (padding excluded), the
    combined plan's slots cover every distinct destination, and the
    port's K1 orders list each shard's segments in the plan's own order."""
    csr = powerlaw_graph(v, 4, seed=seed)
    plan = tmesh.build_edge_plan(csr, shards)
    vl = plan.v_local
    real = plan.src_local < vl
    assert int(real.sum()) == csr.num_edges
    cplan = tmesh.build_combined_plan(csr, shards)
    assert cplan.reuse >= 1.0
    real_slots = cplan.slot_dst < vl
    # each (i, j) bucket: #slots == #distinct dst among its edges
    for i in range(shards):
        for j in range(shards):
            dsts = plan.dst_local[j, i][plan.dst_local[j, i] < vl]
            assert int(real_slots[j, i].sum()) == len(np.unique(dsts))
    u = cplan.slots
    for t in range(shards):
        for p, keys, n_seg in ((plan, plan.dst_local[t].reshape(-1), vl),
                               (cplan, cplan.slot_dst[t].reshape(-1), vl)):
            order, off = p.recv_order[t], p.recv_offsets[t]
            assert np.array_equal(np.sort(order), np.arange(len(keys)))
            assert np.array_equal(keys[order], np.sort(keys, kind="stable"))
            assert off[-1] == int((keys < n_seg).sum())
            for k in (0, n_seg // 2, n_seg - 1):
                seg = order[off[k]:off[k + 1]]
                assert np.all(keys[seg] == k) and np.all(np.diff(seg) > 0)
        segment = (np.arange(shards)[:, None] * u + cplan.edge_slot[t]).reshape(-1)
        order, off = cplan.combine_order[t], cplan.combine_offsets[t]
        assert np.array_equal(segment[order], np.sort(segment))
        assert np.all(np.diff(order)[np.diff(segment[order]) == 0] > 0)  # stable
        assert np.array_equal(np.diff(off), np.bincount(segment, minlength=shards * u))


# --------------------------------------------------------------- steps


@pytest.mark.parametrize("step", ["combined", "baseline-1", "baseline-3"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_steps_are_the_dense_reference_bitwise(mesh_name, kind, step):
    """Both steps (the baseline with 1 and 3 chunks) over two layers, sage
    with ``has_self``: every padded row bitwise the dense reference."""
    mesh = _cpu_mesh(mesh_name)
    csr, feats, specs = exact.exact_graph_and_specs(1001, 16, kind=kind)
    build = tmesh.build_combined_plan if step == "combined" else tmesh.build_edge_plan
    plan = build(csr, mesh.num_shards, kind)
    x = tmesh.pad_features(feats, plan)
    want = dense_reference(tmesh.pad_graph(csr, plan), x, specs, device="cpu")
    chunks = 1 if step == "combined" else int(step.split("-")[1])
    got, moved = tmesh.run_layers(mesh, plan, torch.from_numpy(x), specs, chunks=chunks)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(moved) == len(specs)
    assert (moved[0].all_to_all > 0) == (mesh.num_shards > 1)


ORACLE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist.mesh import (build_combined_plan, build_edge_plan, make_combined_layer_step,
                             make_layer_step, pad_features)
from repro.graphs.synth import make_features, powerlaw_graph
from repro.launch.mesh import make_mesh

assert jax.device_count() == 8, jax.devices()
V, D, F = 700, 16, 12
csr = powerlaw_graph(V, 6, seed=11)
feats = make_features(V, D, seed=12)
rng = np.random.default_rng(13)
w_agg = (rng.standard_normal((D, F)) / 4).astype(np.float32)
w_self = (rng.standard_normal((D, F)) / 4).astype(np.float32)
bias = (rng.standard_normal(F) / 4).astype(np.float32)
mesh = make_mesh((4, 2), ("data", "model"))
cp, ep = build_combined_plan(csr, 4), build_edge_plan(csr, 4)
put = lambda a, *spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))
edge = lambda a: put(a, "data", None, None)
out = {"indptr": csr.indptr, "indices": csr.indices, "feats": feats,
       "w_agg": w_agg, "w_self": w_self, "bias": bias}
for dt in ("float32", "bfloat16"):
    cast = lambda a: a.astype(jnp.dtype(dt))
    x = put(cast(pad_features(feats, cp)), "data", "model")
    wa, ws = put(cast(w_agg), "model", None), put(cast(w_self), "model", None)
    b = put(cast(bias), "model")
    for has_self in (False, True):
        extra = [ws] if has_self else []
        step = make_combined_layer_step(mesh, has_self=has_self)
        y = step(x, edge(cp.src_local), edge(cp.weight), edge(cp.edge_slot),
                 edge(cp.slot_dst), wa, *extra, b)
        out[f"combined-{has_self}-1-{dt}"] = np.asarray(y).astype(np.float32)
        for chunks in ((1, 3) if not has_self else (3,)):
            step = make_layer_step(mesh, has_self=has_self, chunks=chunks)
            y = step(x, edge(ep.src_local), edge(ep.weight), edge(ep.dst_local), wa, *extra, b)
            out[f"baseline-{has_self}-{chunks}-{dt}"] = np.asarray(y).astype(np.float32)
np.savez(sys.argv[1], **out)
"""
ORACLE_CASES = [f"{step}-{dt}" for dt in ("float32", "bfloat16")
                for step in ("combined-False-1", "combined-True-1", "baseline-False-1",
                             "baseline-False-3", "baseline-True-3")]


def _reference_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's both steps on a (4, 2) mesh of 8 placeholder CPU
    devices, in a subprocess (the device count is fixed at JAX's start)."""
    path = tmp_path_factory.mktemp("mesh_oracle") / "oracle.npz"
    env = _reference_env(XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", ORACLE, str(path)], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ORACLE_CASES)
def test_steps_match_the_reference_on_8_devices(oracle, case):
    step_kind, has_self, chunks, dt = case.split("-")
    has_self, dtype = has_self == "True", getattr(torch, dt)
    csr = CSRGraph(indptr=oracle["indptr"], indices=oracle["indices"])
    mesh = _cpu_mesh("4x2")
    if step_kind == "combined":
        plan = tmesh.build_combined_plan(csr, 4)
        step = tmesh.make_combined_layer_step(mesh, has_self=has_self)
    else:
        plan = tmesh.build_edge_plan(csr, 4)
        step = tmesh.make_layer_step(mesh, has_self=has_self, chunks=int(chunks))
    x = tmesh.shard_features(
        mesh, torch.from_numpy(tmesh.pad_features(oracle["feats"], plan)).to(dtype))
    weights = [torch.from_numpy(oracle[k]).to(dtype)
               for k in (("w_agg", "w_self", "bias") if has_self else ("w_agg", "bias"))]
    got = tmesh.gather_shards(step(x, plan, *weights)).float().numpy()
    want = oracle[case]
    assert got.shape == want.shape == (4 * plan.v_local, 12)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("step_kind", ["combined", "baseline-1", "baseline-3"])
def test_wire_bytes_are_the_formula_and_the_bytes_copied(monkeypatch, step_kind):
    """``step.wire_bytes`` equals ``wire_bytes``' formula and the bytes of
    every tensor the step moved between distinct mesh positions."""
    copied = []
    move = tmesh.LayerStep._move

    def spy(self, x, frm, to):
        if frm != to:
            copied.append(x.nbytes)
        return move(self, x, frm, to)

    monkeypatch.setattr(tmesh.LayerStep, "_move", spy)
    mesh = _cpu_mesh("4x2")
    csr = powerlaw_graph(600, 6, seed=3)
    d, f = 16, 12
    rng = np.random.default_rng(0)
    if step_kind == "combined":
        plan = tmesh.build_combined_plan(csr, 4)
        step, rows = tmesh.make_combined_layer_step(mesh), plan.slots
    else:
        chunks = int(step_kind.split("-")[1])
        plan = tmesh.build_edge_plan(csr, 4)
        step = tmesh.make_layer_step(mesh, chunks=chunks)
        rows = chunks * -(-plan.bucket // chunks)
    x = tmesh.shard_features(mesh, tmesh.pad_features(
        rng.standard_normal((600, d)).astype(np.float32), plan))
    step(x, plan, torch.from_numpy(rng.standard_normal((d, f)).astype(np.float32)),
         torch.zeros(f))
    want = tmesh.wire_bytes(4, 2, rows, d, 4, plan.v_local, f)
    assert step.wire_bytes == want
    assert sum(copied) == want.total
    assert want.reduce_scatter == 4 * 1 * plan.v_local * f * 4


def test_steps_reject_what_shard_map_would():
    mesh = _cpu_mesh("4x2")
    csr, feats, specs = exact.exact_graph_and_specs(400, 16, kind="gcn")
    plan = tmesh.build_combined_plan(csr, 4)
    x = tmesh.shard_features(mesh, tmesh.pad_features(feats, plan))
    step = tmesh.make_combined_layer_step(mesh)
    with pytest.raises(ValueError, match="output width 7 does not divide by 2"):
        step(x, plan, torch.zeros(16, 7), torch.zeros(7))
    with pytest.raises(ValueError, match="width 15 does not divide by 2"):
        tmesh.shard_features(mesh, np.zeros((4 * plan.v_local, 15), np.float32))
    with pytest.raises(TypeError, match="EdgePlan"):
        step(x, tmesh.build_edge_plan(csr, 4), torch.zeros(16, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="2 shards"):
        step(x, tmesh.build_combined_plan(csr, 2), torch.zeros(16, 8), torch.zeros(8))
    with pytest.raises(TypeError, match="dtype"):
        step(x, plan, torch.zeros(16, 8, dtype=torch.float64), torch.zeros(8))
    with pytest.raises(ValueError, match="gcn and sage"):
        tmesh.run_layers(mesh, plan, tmesh.pad_features(feats, plan),
                         [dataclasses.replace(specs[0], kind="gin")])
    with pytest.raises(ValueError, match="'model' axis"):
        tmesh.make_layer_step(make_mesh((4,), ("data",), devices="cpu"))


# --------------------------------------------------------------- meshes


def test_building_a_mesh_touches_no_device(monkeypatch):
    """Mesh constructors hold names only; a CUDA mesh raises when a step is
    built for it on a machine without a card."""
    def no_device(*_a, **_k):
        raise AssertionError("a mesh constructor touched the device")

    for name in ("is_available", "device_count", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.devices) == ((16, 16), ("data", "model"), None)
    assert (multi.num_shards, multi.model_size, multi.dp_axes) == (32, 16, ("pod", "data"))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cuda:0"] * 8)
    assert mesh.devices == ("cuda:0",) * 8 and mesh.num_shards == 4
    assert make_mesh((4, 2), ("data", "model"), devices="cuda:0") == make_mesh(
        (4, 2), ("data", "model"), devices=["cuda:0"] * 8)
    with pytest.raises(ValueError, match="needs 8 device names"):
        make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 3)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tmesh.make_combined_layer_step(mesh)
    with pytest.raises(RuntimeError, match="needs >= 8 CUDA devices, have 0"):
        tmesh.make_layer_step(make_mesh((4, 2), ("data", "model")))


def test_mesh_positions_flatten_the_data_axes_row_major():
    """Position (i, m): the data axes (every axis but ``model``) flattened
    in row-major order, wherever ``model`` sits."""
    names = [f"cpu:{k}" for k in range(8)]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=names)
    assert mesh.positions().tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    mesh = make_mesh((2, 4), ("model", "data"), devices=names)
    assert (mesh.num_shards, mesh.model_size) == (4, 2)
    assert mesh.positions().tolist() == [[0, 4], [1, 5], [2, 6], [3, 7]]


# --------------------------------------------------------------- dry-run

DRYRUN_KEYS = ("arch", "shape", "mesh", "combine", "V", "E", "D", "F", "shards", "bucket",
               "v_local", "reuse", "slots", "status")


def test_dryrun_matches_the_reference_records(tmp_path):
    ref_out, port_out = tmp_path / "ref", tmp_path / "port"
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun_gnn", "--devices", "8",
                        "--mesh-shape", "4,2", "--out", str(ref_out)],
                       capture_output=True, text=True, env=_reference_env(), cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = dryrun_gnn.main(["--mesh-shape", "4,2", "--out", str(port_out)])
    assert len(recs) == 2
    for variant in ("baseline", "combined"):
        name = f"gnn__4x2__{variant}.json"
        want = json.loads((ref_out / name).read_text())
        got = json.loads((port_out / name).read_text())
        assert got["status"] == "ok"
        for key in DRYRUN_KEYS:
            assert (key in got) == (key in want) and got.get(key) == want.get(key), key
        for key in ("argument_bytes", "output_bytes"):
            assert got["memory_analysis"][key] == want["memory_analysis"][key], key
        s, vl, dl, f = 4, got["v_local"], 512, 128
        rows = got.get("slots", got["bucket"])
        assert got["cost"] == {
            "wire_bytes": 3 * rows * dl * 2 + 1 * vl * 64 * 4,
            "message_bytes": s * rows * dl * 4,
            "agg_flops": 2 * s * got["bucket"] * dl + 2 * s * rows * dl,
            "gemm_flops": 2 * vl * dl * f,
        }
    combined = json.loads((port_out / "gnn__4x2__combined.json").read_text())
    assert combined["memory_analysis"]["argument_bytes"] == 81_476_111_104
    assert combined["reuse"] == 6.536162480609346


def test_dryrun_default_plans_both_production_meshes(tmp_path):
    recs = dryrun_gnn.main(["--out", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"gnn__{tag}__{v}.json" for tag in ("16x16", "2x16x16") for v in ("baseline", "combined")]
    assert [(r["mesh"], r["combine"], r["shards"]) for r in recs] == [
        ("16x16", False, 16), ("16x16", True, 16), ("2x16x16", False, 32), ("2x16x16", True, 32)]
    assert all(r["status"] == "ok" for r in recs)
    assert recs[1]["reuse"] == recs[3]["reuse"]  # one plan at 16 shards for both
