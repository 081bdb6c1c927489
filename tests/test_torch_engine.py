"""The port's main path (store build → AtlasSession.infer) against the
JAX package's, on the same numpy inputs.

The port runs with ``backend="cpu"`` (the kernels' plain versions), the
reference with ``backend="numpy"``.  On ``repro.exact`` graphs every sum
is exact in any order, so spills compare with ``array_equal``; on
power-law graphs fp32 allclose 1e-5.  Chunk aggregation partials compare
at the backend grid's rtol=1e-4/atol=1e-5, because ``np.add.reduceat``
does not add rows in order.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro import exact as rexact
from repro.core.atlas import AtlasConfig as RConfig
from repro.core.atlas import spills_to_dense as r_dense
from repro.core.broadcast import chunk_aggregate_numpy as r_agg_numpy
from repro.graphs.synth import make_features, powerlaw_graph
from repro.models import gnn as rgnn
from repro.session import AtlasSession as RSession
from repro.session import RunManifest as RRunManifest
from repro.storage.layout import GraphStore as RStore
from repro_torch.core import broadcast as tbroadcast
from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.models import gnn as tgnn
from repro_torch.session import AtlasSession, RunManifest
from repro_torch.storage.layout import GraphStore

from tests.test_torch_gnn import _as_dicts, int_gin_specs
from tests.test_torch_gpu import SPMM_GRID

ROOT = pathlib.Path(__file__).resolve().parents[1]


# --------------------------------------------------------------- chunks


@pytest.mark.parametrize("n,d,m,num_dst", SPMM_GRID)
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_chunk_aggregate_cpu_matches_numpy_oracle(n, d, m, num_dst, kind):
    rng = np.random.default_rng(n * 7 + m + d)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    src_local = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, num_dst, m).astype(np.int64)
    in_deg = rng.integers(1, 9, num_dst).astype(np.int64)
    src_g = rng.integers(0, num_dst, m).astype(np.int64)
    w = rgnn.edge_weights(kind, src_g, dst, in_deg).astype(np.float32)
    ref_u, ref_p, ref_c = r_agg_numpy(feats, src_local, dst, w)
    u, p, c = tbroadcast.chunk_aggregate("cpu")(feats, src_local, dst, w)
    assert u.dtype == np.int64 and c.dtype == np.int64 and p.dtype == np.float32
    np.testing.assert_array_equal(u, ref_u)
    np.testing.assert_array_equal(c, ref_c)
    assert p.shape == ref_p.shape
    np.testing.assert_allclose(p, ref_p, rtol=1e-4, atol=1e-5)
    # the in-port host oracle is the reference's function, copied
    for a, b in zip(tbroadcast.chunk_aggregate("numpy")(feats, src_local, dst, w),
                    (ref_u, ref_p, ref_c)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_aggregate_cpu_exact_chunks(seed):
    """Integer features, power-of-two weights: every order of summation
    gives the same bits, so the port equals reduceat exactly."""
    rng = np.random.default_rng(seed)
    n, d, m = 120, 16, 900
    feats = rexact.int_features(n, d, seed=seed)
    src_local = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, 300, m).astype(np.int64)
    w = (2.0 ** -rng.integers(0, 4, m)).astype(np.float32)
    for a, b in zip(tbroadcast.chunk_aggregate("cpu")(feats, src_local, dst, w),
                    r_agg_numpy(feats, src_local, dst, w)):
        np.testing.assert_array_equal(a, b)


def test_chunk_aggregate_dispatcher(monkeypatch):
    assert tbroadcast.chunk_aggregate("numpy") is tbroadcast.chunk_aggregate_numpy
    agg = tbroadcast.chunk_aggregate("cpu")
    assert isinstance(agg, tbroadcast.ChunkAggregator) and agg.backend == "cpu"
    with pytest.raises(ValueError, match="unknown broadcast backend"):
        tbroadcast.chunk_aggregate("pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbroadcast.chunk_aggregate("cuda")


# ---------------------------------------------------------------- store


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("order", ["at", "original", "rnd"])
def test_store_byte_identical_to_reference(tmp_path, order):
    """Same CSR, features and order: the port writes the reference's
    store file for file, byte for byte (manifest paths included, so both
    are built at the same root in turn)."""
    csr = powerlaw_graph(700, 6, seed=2)
    feats = make_features(700, 12, seed=3)
    root = str(tmp_path / "store")
    RStore.create(root, csr, feats, num_partitions=4, order=order)
    ref = _tree(root)
    shutil.rmtree(root)
    GraphStore.create(root, csr, feats, num_partitions=4, order=order)
    got = _tree(root)
    assert sorted(got) == sorted(ref)
    if order != "original":
        assert {"old_of_new.npy", "new_of_old.npy"} <= set(got)
    for name in ref:
        assert got[name] == ref[name], name
    assert GraphStore.open(root).ordering_digest == RStore.open(root).ordering_digest


# ---------------------------------------------------------------- infer


def _infer_pair(tmp_path, csr, feats, ref_specs, **cfg):
    rstore = RStore.create(str(tmp_path / "r"), csr, feats, num_partitions=4, order="at")
    tstore = GraphStore.create(str(tmp_path / "t"), csr, feats, num_partitions=4, order="at")
    with RSession(rstore, config=RConfig(backend="numpy", **cfg)) as s:
        ref = s.infer(ref_specs)
    port_specs = tgnn.specs_from_numpy(_as_dicts(ref_specs), device="cpu")
    with AtlasSession(tstore, config=AtlasConfig(backend="cpu", **cfg)) as s:
        got = s.infer(port_specs)
    v = csr.num_vertices
    dim = ref_specs[-1].out_dim
    return (
        spills_to_dense(got.final.spills, v, dim), got.metrics,
        r_dense(ref.final.spills, v, dim), ref.metrics,
    )


def _exact_case(kind):
    if kind == "gin":
        csr = rexact.pow_degree_graph(512, (4, 16), seed=7, self_loops=True)
        return csr, rexact.int_features(512, 8, seed=8), int_gin_specs([8, 8, 4], seed=9)
    return rexact.exact_graph_and_specs(512, 8, kind=kind)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_infer_exact_spills_equal_reference(tmp_path, kind):
    csr, feats, specs = _exact_case(kind)
    got, gm, ref, rm = _infer_pair(
        tmp_path, csr, feats, specs, chunk_bytes=96 * 8 * 4, hot_slots=96
    )
    np.testing.assert_array_equal(got, ref)
    assert [m.chunks for m in gm] == [m.chunks for m in rm]
    assert sum(m.evictions for m in gm) > 0


@pytest.mark.parametrize("policy", ["at", "lru", "rnd"])
def test_infer_evictions_and_reloads_equal_reference(tmp_path, policy):
    csr, feats, specs = rexact.exact_graph_and_specs(512, 8, kind="sage")
    got, gm, ref, rm = _infer_pair(
        tmp_path, csr, feats, specs, chunk_bytes=64 * 8 * 4, hot_slots=80,
        eviction=policy,
    )
    np.testing.assert_array_equal(got, ref)
    assert [(m.evictions, m.reloads) for m in gm] == [
        (m.evictions, m.reloads) for m in rm
    ]
    assert all(m.evictions > 0 for m in gm)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_infer_powerlaw_allclose_reference(tmp_path, kind):
    csr = powerlaw_graph(1024, 8, seed=11)
    feats = make_features(1024, 16, seed=12)
    specs = rgnn.init_gnn_params(kind, [16, 24, 8], seed=13)
    got, _, ref, _ = _infer_pair(
        tmp_path, csr, feats, specs, chunk_bytes=128 * 16 * 4, hot_slots=300
    )
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


def _smoke_module():
    """chip_smoke.py, imported as a module (it needs no card to import)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_smoke_exact_gin_case_is_exact(tmp_path):
    """The smoke's exact GIN fixture (``[dist]`` on the card, at 20,000
    vertices): the same graph, features and integer weights as the
    reference's, at a small V the port's infer equals the reference's
    bitwise, and every intermediate a GIN layer forms at those dims stays
    an integer below 2^24 in the worst case (in-degree 16 with the
    self-loop, plus the self message), so any summation order is exact."""
    cs = _smoke_module()
    v = 600
    csr, feats, specs = cs.exact_gin_case(v)
    ref_csr = rexact.pow_degree_graph(v, (4, 16), seed=7, self_loops=True)
    ref_specs = int_gin_specs(cs.DIST_GIN_DIMS, seed=9)
    np.testing.assert_array_equal(csr.indptr, ref_csr.indptr)
    np.testing.assert_array_equal(csr.indices, ref_csr.indices)
    np.testing.assert_array_equal(feats, rexact.int_features(v, cs.DIST_GIN_DIMS[0], seed=8))
    for got, want in zip(specs, ref_specs, strict=True):
        assert (got.kind, got.in_dim, got.out_dim, got.activation) == (
            want.kind, want.in_dim, want.out_dim, want.activation)
        for k in want.params:
            np.testing.assert_array_equal(got.params[k], want.params[k])
    # the worst case over any graph of these in-degrees: |row sums| through abs weights
    bound = np.full(cs.DIST_GIN_DIMS[0], float(np.abs(feats).max()))
    worst = []
    for spec in specs:
        p = spec.params
        bound = bound * (16 + 1 + float(p["eps"]))
        worst.append(bound.max())
        bound = bound @ np.abs(p["w1"]) + np.abs(p["b1"])
        worst.append(bound.max())
        bound = bound @ np.abs(p["w2"]) + np.abs(p["b2"])
        worst.append(bound.max())
    assert max(worst) < 2**24, worst
    got, gm, ref, _ = _infer_pair(tmp_path, ref_csr, feats, ref_specs,
                                  chunk_bytes=96 * 8 * 4, hot_slots=96)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.round(got))
    assert sum(m.evictions for m in gm) > 0


def test_staged_and_serial_spills_identical(tmp_path):
    """Within the port, the staging ring moves only where aggregation
    runs: spill files are bit-identical to the serial loop."""
    csr = powerlaw_graph(600, 6, seed=47)
    feats = make_features(600, 12, seed=47)
    specs = tgnn.init_gnn_params("sage", [12, 10, 6], seed=11)
    raw = {}
    for mode in ("staged", "serial"):
        store = GraphStore.create(str(tmp_path / mode), csr, feats, num_partitions=4)
        cfg = AtlasConfig(chunk_bytes=48 * 12 * 4, hot_slots=150, backend="cpu",
                          pipeline=mode)
        with AtlasSession(store, config=cfg) as s:
            result = s.infer(specs)
        raw[mode] = {
            os.path.basename(f.path): open(f.path, "rb").read()
            for f in result.final.spills.files
        }
    assert raw["staged"].keys() == raw["serial"].keys()
    for name in raw["staged"]:
        assert raw["staged"][name] == raw["serial"][name], name


def test_run_manifest_interchangeable_with_reference(tmp_path):
    """Schema v3, the same JSON: each package loads the other's manifest,
    and a port run resumes as a no-op from its own."""
    csr, feats, specs = rexact.exact_graph_and_specs(256, 8, kind="gcn")
    store = GraphStore.create(str(tmp_path / "t"), csr, feats, num_partitions=4)
    port_specs = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    cfg = AtlasConfig(backend="cpu", delete_intermediate=False)
    with AtlasSession(store, config=cfg) as s:
        first = s.infer(port_specs)
        path = s.run_manifest_path
    ref = RRunManifest.load(path)
    assert ref.completed_layers == len(specs) == first.manifest.completed_layers
    assert ref.store_digest == store.ordering_digest
    ref.save(path)
    assert RunManifest.load(path) == first.manifest
    with AtlasSession(store, config=cfg) as s:
        again = s.infer(port_specs, resume=True)
    assert again.metrics == []
    np.testing.assert_array_equal(
        spills_to_dense(again.final.spills, 256, specs[-1].out_dim),
        spills_to_dense(first.final.spills, 256, specs[-1].out_dim),
    )


def test_resume_after_crash_replays_only_the_failed_layer(tmp_path, monkeypatch):
    """A crash in layer 2 leaves the manifest at layer 1; resume runs
    layer 2 alone and lands on the uninterrupted run's bits."""
    from repro_torch.core.atlas import AtlasEngine

    csr, feats, specs = rexact.exact_graph_and_specs(256, 8, kind="sage")
    port_specs = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    cfg = AtlasConfig(backend="cpu", chunk_bytes=64 * 8 * 4, hot_slots=80)
    dim = specs[-1].out_dim
    with AtlasSession(GraphStore.create(str(tmp_path / "a"), csr, feats),
                      config=cfg) as s:
        want = spills_to_dense(s.infer(port_specs).final.spills, 256, dim)

    run_layer = AtlasEngine.run_layer

    def crash_in_layer_2(self, *args, layer_index=0, **kwargs):
        if layer_index == 1:
            raise RuntimeError("simulated crash")
        return run_layer(self, *args, layer_index=layer_index, **kwargs)

    store = GraphStore.create(str(tmp_path / "b"), csr, feats)
    with AtlasSession(store, config=cfg) as s:
        monkeypatch.setattr(AtlasEngine, "run_layer", crash_in_layer_2)
        with pytest.raises(RuntimeError, match="simulated crash"):
            s.infer(port_specs)
        assert RunManifest.load(s.run_manifest_path).completed_layers == 1
        monkeypatch.setattr(AtlasEngine, "run_layer", run_layer)
        again = s.infer(port_specs, resume=True)
    assert [m.layer for m in again.metrics] == [1]
    np.testing.assert_array_equal(spills_to_dense(again.final.spills, 256, dim), want)


# --------------------------------------------------- devices and errors


def test_default_backend_is_cuda_and_never_falls_back(tmp_path, monkeypatch):
    assert AtlasConfig().backend == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr, feats, specs = rexact.exact_graph_and_specs(64, 4, kind="gcn")
    store = GraphStore.create(str(tmp_path / "t"), csr, feats)
    with AtlasSession(store) as s:
        with pytest.raises(RuntimeError, match="CUDA"):
            s.infer(tgnn.specs_from_numpy(_as_dicts(specs), device="cpu"))
        assert not os.path.exists(s.run_manifest_path)


def _atlas_threads():
    return {t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("atlas-")}


@pytest.mark.parametrize("where", ["aggregate", "transform"])
def test_kernel_error_tears_threads_down(tmp_path, monkeypatch, where):
    """A raise inside a kernel wrapper — on the staging thread or the
    graduation offload thread — surfaces from infer, and no engine
    thread outlives the failed layer."""
    from repro_torch.core import graduation

    def boom(*a, **k):
        raise RuntimeError(f"{where} launch failed")

    if where == "aggregate":
        monkeypatch.setattr(tbroadcast, "segment_reduce_sorted", boom)
    else:
        monkeypatch.setattr(graduation, "layer_update", boom)
    before = _atlas_threads()
    csr = powerlaw_graph(400, 6, seed=1)
    store = GraphStore.create(str(tmp_path / "t"), csr, make_features(400, 8, seed=2))
    cfg = AtlasConfig(backend="cpu", chunk_bytes=32 * 8 * 4, hot_slots=100)
    with AtlasSession(store, config=cfg) as s:
        with pytest.raises(RuntimeError, match=f"{where} launch failed"):
            s.infer(tgnn.init_gnn_params("sage", [8, 6], seed=0))
    for t in threading.enumerate():
        if t.name.startswith("atlas-") and t.name not in before:
            t.join(timeout=10)
    assert _atlas_threads() <= before


# ------------------------------------------------------------ isolation


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.session, repro_torch.kernels.ops, repro_torch.exact\n"
        "import repro_torch.core, repro_torch.storage, repro_torch.obs\n"
        "import repro_torch.configs, repro_torch.models.layers, repro_torch.models.mamba\n"
        "import repro_torch.models.lm, repro_torch.train.step, repro_torch.serving.engine\n"
        "import repro_torch.launch.serve, repro_torch.launch.infer_gnn\n"
        "import repro_torch.serve_gnn, repro_torch.serving.frontend\n"
        "import repro_torch.dist, repro_torch.core.gather_ref\n"
        "import repro_torch.launch.infer_dist, repro_torch.launch.obs_report\n"
        "import repro_torch.train.optimizer, repro_torch.train.checkpoint\n"
        "import repro_torch.data.pipeline, repro_torch.launch.train\n"
        "from repro_torch.configs import list_archs, get_config\n"
        "assert [get_config(a).name for a in list_archs()] == list_archs()\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_repro_nor_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in files}
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == ["torch_distributed_gnn.py", "torch_quickstart.py",
                                          "torch_serve_embeddings.py", "torch_serve_lm.py",
                                          "torch_train_lm.py"]
    files += [ROOT / "chip_smoke.py", *examples]
    assert {
        "configs/registry.py", "configs/qwen3_14b.py", "configs/mamba2_2p7b.py",
        "models/layers.py", "models/mamba.py", "models/lm.py", "train/step.py",
        "serving/engine.py", "launch/serve.py", "kernels/flash_attention.py",
        "kernels/ssd_chunk.py", "kernels/rms_norm.py",
        "serve_gnn/__init__.py", "serve_gnn/leases.py", "serve_gnn/servable.py",
        "serve_gnn/page_cache.py", "serve_gnn/query.py", "serving/frontend.py",
        "launch/infer_gnn.py", "dist/__init__.py", "dist/partition.py",
        "dist/exchange.py", "dist/worker.py", "dist/session.py",
        "core/gather_ref.py", "launch/infer_dist.py", "launch/obs_report.py",
        "train/optimizer.py", "train/checkpoint.py", "data/pipeline.py", "launch/train.py",
        "dist/mesh.py", "launch/mesh.py", "launch/dryrun_gnn.py",
        "distributed/__init__.py", "distributed/sharding.py", "distributed/annotate.py",
        "distributed/spmd.py", "distributed/elastic.py", "distributed/compression.py",
        "distributed/pipeline.py", "launch/compression_check.py", "launch/pipeline_check.py",
        "launch/elastic_check.py", "launch/dryrun.py", "perf/__init__.py", "perf/hlo_cost.py",
    } <= names
    assert len(files) > 40
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), f"{path}: imports {mod}"
