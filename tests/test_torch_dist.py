"""The port's sharded inference (repro_torch.dist), gather baselines
(repro_torch.core.gather_ref) and trace report
(repro_torch.launch.obs_report) against the JAX package's, on the same
numpy inputs.

The port runs with ``backend="cpu"`` (the kernels' plain versions), the
reference with its default ``backend="numpy"``; the reference's specs
cross over through ``specs_from_numpy(..., device="cpu")``.  On
``repro.exact`` graphs every sum is exact in any order, so outputs
compare with ``np.array_equal``; on power-law graphs fp32 allclose 1e-5.
Exchange record counts and ``GatherStats`` are integers and compare
equal.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro.core import gather_ref as r_gather
from repro.core.atlas import AtlasConfig as RConfig
from repro.core.atlas import spills_to_dense as r_dense
from repro.dist import DistRunManifest as RDistRunManifest
from repro.dist import DistSession as RDistSession
from repro.exact import exact_graph_and_specs
from repro.graphs.synth import make_features, powerlaw_graph
from repro.launch import obs_report as r_obs
from repro.models import gnn as rgnn
from repro.session import AtlasSession as RSession
from repro.session import StaleManifestError as RStaleManifestError
from repro.storage.layout import GraphStore as RStore
from repro_torch.core import gather_ref as t_gather
from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.dist import DistRunManifest, DistSession, DistWorkerError, ShardPlan
from repro_torch.dist.exchange import LocalExchange, MeshExchange, make_exchange
from repro_torch.launch import obs_report as t_obs
from repro_torch.models import gnn as tgnn
from repro_torch.session import AtlasSession, StaleManifestError
from repro_torch.storage.layout import GraphStore

from tests.test_torch_gnn import _as_dicts, int_gin_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
V, D = 1500, 8


def _cfg(**kw):
    # small chunks + tight hot store: shards really stream, evict, reload
    kw.setdefault("chunk_bytes", 1 << 14)
    kw.setdefault("hot_slots", 96)
    return kw


def _stores(tmp_path, csr, feats):
    return (
        RStore.create(str(tmp_path / "rstore"), csr, feats, num_partitions=4),
        GraphStore.create(str(tmp_path / "tstore"), csr, feats, num_partitions=4),
    )


def _port_specs(ref_specs):
    return tgnn.specs_from_numpy(_as_dicts(ref_specs), device="cpu")


def _final(result, v):
    return spills_to_dense(result.final.spills, v, result.final.dim)


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    """Per kind: the exact fixture, its stores, and both packages'
    single-machine final layers (array_equal to each other)."""
    out = {}
    for kind in ("gcn", "sage"):
        tmp = tmp_path_factory.mktemp(kind)
        csr, feats, specs = exact_graph_and_specs(V, D, kind=kind)
        rstore, tstore = _stores(tmp, csr, feats)
        with RSession(rstore, config=RConfig(**_cfg()), workdir=str(tmp / "rs")) as s:
            res = s.infer(specs)
            ref = r_dense(res.final.spills, V, res.final.dim)
        with AtlasSession(tstore, config=AtlasConfig(backend="cpu", **_cfg()),
                          workdir=str(tmp / "ts")) as s:
            got = _final(s.infer(_port_specs(specs)), V)
        np.testing.assert_array_equal(got, ref)
        out[kind] = dict(specs=specs, rstore=rstore, tstore=tstore, ref=ref, tmp=tmp)
    return out


# --------------------------------------------------------------------------
# shard sweep: bitwise the reference's DistSession and the single machine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_shard_sweep_matches_reference(single_runs, kind, shards):
    """1-, 2- and 4-shard thread runs: the port's final spills equal the
    reference DistSession's and the single-machine run's bit for bit,
    every shard routes the reference's exchange records and bytes, and a
    session reader serves the published merge."""
    run = single_runs[kind]
    tmp, specs = run["tmp"], run["specs"]
    with RDistSession(run["rstore"], shards=shards, config=RConfig(**_cfg()),
                      workdir=str(tmp / f"rd{shards}")) as dist:
        rres = dist.infer(specs)
        rdense = r_dense(rres.final.spills, V, rres.final.dim)
    with DistSession(run["tstore"], shards=shards,
                     config=AtlasConfig(backend="cpu", **_cfg()),
                     workdir=str(tmp / f"td{shards}")) as dist:
        res = dist.infer(_port_specs(specs))
        dense = _final(res, V)
        probe = np.arange(0, V, 61)
        dist.publish(res.final)
        with dist.reader(res.final.layer) as reader:
            np.testing.assert_array_equal(reader.lookup(probe), run["ref"][probe])
    np.testing.assert_array_equal(dense, rdense)
    np.testing.assert_array_equal(dense, run["ref"])
    assert sorted(res.shard_reports) == sorted(rres.shard_reports)
    for layer, reports in res.shard_reports.items():
        assert len(reports) == shards
        assert sum(r["rows"] for r in reports) == V
        for got, want in zip(reports, rres.shard_reports[layer]):
            assert got["exchange"] == want["exchange"], (layer, got["shard"])
            for key in ("rows", "chunks", "graduated", "evictions", "reloads"):
                assert got[key] == want[key], (layer, got["shard"], key)


def test_two_shards_route_real_traffic(single_runs):
    """The ring-offset exact graph has cross-boundary edges: a 2-shard
    run moves real records through the exchange, each collected once."""
    run = single_runs["gcn"]
    with DistSession(run["tstore"], shards=2,
                     config=AtlasConfig(backend="cpu", **_cfg()),
                     workdir=str(run["tmp"] / "traffic")) as dist:
        res = dist.infer(_port_specs(run["specs"]))
    ex = [r["exchange"] for reports in res.shard_reports.values() for r in reports]
    assert all(e["sent_records"] > 0 and e["recv_records"] > 0 for e in ex)
    assert sum(e["sent_bytes"] for e in ex) == sum(e["recv_bytes"] for e in ex)


# --------------------------------------------------------------------------
# manifests: one schema, read across packages
# --------------------------------------------------------------------------


def _payload(path, prefix):
    with open(path) as f:
        return json.loads(f.read().replace(prefix, "<workdir>"))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_manifests_cross_read(single_runs, kind):
    run = single_runs[kind]
    tmp = run["tmp"]
    rwd, twd = str(tmp / "rman"), str(tmp / "tman")
    cfg = _cfg()
    cfg["delete_intermediate"] = False
    with RDistSession(run["rstore"], shards=2, config=RConfig(**cfg), workdir=rwd) as d:
        d.infer(run["specs"])
        rpath = d.run_manifest_path
    with DistSession(run["tstore"], shards=2, config=AtlasConfig(backend="cpu", **cfg),
                     workdir=twd) as d:
        d.infer(_port_specs(run["specs"]))
        tpath = d.run_manifest_path
    assert _payload(tpath, twd) == _payload(rpath, rwd)
    assert _payload(tpath, twd)["schema_version"] == 1
    ported, ref = DistRunManifest.load(rpath), RDistRunManifest.load(tpath)
    assert dataclasses.asdict(ported) == dataclasses.asdict(RDistRunManifest.load(rpath))
    assert dataclasses.asdict(ref) == dataclasses.asdict(DistRunManifest.load(tpath))
    # each package accepts the other's file for a resume of this store
    dims = [s.out_dim for s in run["specs"]]
    ported.validate_resume(rpath, V, 2, dims, store_digest=run["tstore"].ordering_digest)
    ref.validate_resume(tpath, V, 2, dims, store_digest=run["rstore"].ordering_digest)


# --------------------------------------------------------------------------
# failure model
# --------------------------------------------------------------------------


def test_worker_death_keeps_manifest_unadvanced_and_resume_replays(single_runs):
    """Shard 1 dies between its post and collect in layer 2: every worker
    fails fast, the manifest records only layer 1, and a fresh session's
    resume replays layer 2 to the reference's bits."""
    run = single_runs["sage"]
    workdir = str(run["tmp"] / "death")
    cfg = AtlasConfig(backend="cpu", **_cfg())

    def die_in_layer_1(shard, layer, phase):
        if shard == 1 and layer == 1 and phase == "post":
            raise RuntimeError("injected worker death")

    specs = _port_specs(run["specs"])
    with DistSession(run["tstore"], shards=2, config=cfg, workdir=workdir,
                     exchange_timeout_s=30.0) as dist:
        with pytest.raises(DistWorkerError) as ei:
            dist.infer(specs, fault=die_in_layer_1)
        assert ei.value.shard == 1 and ei.value.layer == 1
        manifest = DistRunManifest.load(dist.run_manifest_path)
        assert manifest.completed_layers == 1
        for paths in manifest.spills[1].values():
            assert paths and all(os.path.exists(p) for p in paths)
    with DistSession(run["tstore"], shards=2, config=cfg, workdir=workdir) as dist:
        res = dist.infer(specs, resume=True)
        assert sorted(res.shard_reports) == [2]  # only the incomplete layer
        np.testing.assert_array_equal(_final(res, V), run["ref"])


def test_resume_rejects_stale_manifests(single_runs):
    run = single_runs["gcn"]
    store = run["tstore"]
    workdir = str(run["tmp"] / "stale")
    cfg = AtlasConfig(backend="cpu", **_cfg())
    specs = _port_specs(run["specs"])
    with DistSession(store, shards=2, config=cfg, workdir=workdir) as dist:
        dist.infer(specs)
        path = dist.run_manifest_path
    dims = [s.out_dim for s in specs]
    digest = store.ordering_digest
    DistRunManifest.load(path).validate_resume(path, V, 2, dims, store_digest=digest)
    for args, kwargs, match in (
        ((V, 4, dims), {"store_digest": digest}, "shards"),
        ((V + 1, 2, dims), {"store_digest": digest}, "vertices"),
        ((V, 2, dims), {"store_ordering": "at", "store_digest": "bogus"}, "digest"),
        ((V, 2, dims[:-1]), {"store_digest": digest}, "layer dims"),
    ):
        with pytest.raises(StaleManifestError, match=match):
            DistRunManifest.load(path).validate_resume(path, *args, **kwargs)
    m = DistRunManifest.load(path)
    os.remove(m.spills[m.completed_layers][0][0])
    with pytest.raises(StaleManifestError, match="missing"):
        DistRunManifest.load(path).validate_resume(path, V, 2, dims, store_digest=digest)
    # the reference refuses the same broken manifest for the same reason
    with pytest.raises(RStaleManifestError, match="missing"):
        RDistRunManifest.load(path).validate_resume(path, V, 2, dims, store_digest=digest)
    with DistSession(store, shards=4, config=cfg, workdir=workdir) as dist:
        with pytest.raises(StaleManifestError):
            dist.infer(specs, resume=True)


def test_manifest_schema_version_gate(tmp_path):
    path = str(tmp_path / "m.json")
    DistRunManifest(num_vertices=10, num_layers=2, num_shards=2).save(path)
    assert RDistRunManifest.load(path).num_shards == 2
    data = json.load(open(path))
    data["schema_version"] = 999
    json.dump(data, open(path, "w"))
    with pytest.raises(StaleManifestError, match="schema_version"):
        DistRunManifest.load(path)
    with pytest.raises(RStaleManifestError, match="schema_version"):
        RDistRunManifest.load(path)
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.raises(StaleManifestError, match="not valid JSON"):
        DistRunManifest.load(path)


def test_session_rejects_bad_modes(single_runs):
    store = single_runs["gcn"]["tstore"]
    for kwargs, match in (
        ({"exchange": "grpc"}, "unknown exchange"),
        ({"workers": "fork"}, "unknown workers"),
        ({"workers": "process", "exchange": "mesh"}, "requires exchange='local'"),
    ):
        with pytest.raises(ValueError, match=match):
            DistSession(store, shards=2, config=AtlasConfig(backend="cpu"), **kwargs)


def test_cuda_backend_raises_before_any_work(single_runs, monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with DistSession(single_runs["gcn"]["tstore"], shards=2, config=AtlasConfig(),
                     workdir=str(tmp_path / "w")) as dist:
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.infer(_port_specs(single_runs["gcn"]["specs"]))
    assert not os.path.exists(tmp_path / "w")


def test_shard_plan_matches_reference():
    from repro.dist import ShardPlan as RShardPlan

    ids = np.arange(0, 1001, 7)
    for v, s in ((1001, 1), (1001, 3), (17, 4)):
        got, want = ShardPlan(v, s), RShardPlan(v, s)
        np.testing.assert_array_equal(got.bounds, want.bounds)
        np.testing.assert_array_equal(got.shard_of(ids % v), want.shard_of(ids % v))
        assert [got.range_of(i) for i in range(s)] == [want.range_of(i) for i in range(s)]
    with pytest.raises(ValueError):
        ShardPlan(3, 4)


# --------------------------------------------------------------------------
# process workers and the mesh exchange
# --------------------------------------------------------------------------


def _run_cli(extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.infer_dist", *extra]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(ROOT),
                       timeout=timeout)
    assert r.returncode == 0, f"\nstdout:{r.stdout}\nstderr:{r.stderr[-3000:]}"
    return json.loads(r.stdout[r.stdout.index("{"):])


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_process_mode_2proc_cli(kind):
    """Two worker processes per layer on the CPU, file-backed exchange,
    the whole launcher: infer -> publish -> serve -> bitwise against the
    single machine (the CLI exits non-zero on any mismatch)."""
    report = _run_cli([
        "--vertices", "1200", "--feat-dim", "8", "--kind", kind,
        "--shards", "2", "--workers", "process", "--device", "cpu",
        "--chunk-bytes", str(1 << 14), "--hot-slots", "96",
    ])
    assert report["bit_identical"] and report["served_identical"]
    assert report["shards"] == 2 and report["device"] == "cpu"
    for reports in report["shard_reports"].values():
        assert [r["shard"] for r in reports] == [0, 1]
        assert all(r["startup_seconds"] > 0 for r in reports)


def test_process_mode_matches_reference_traffic(single_runs):
    """Process workers route the reference's records: the same exchange
    counts per shard and layer as the reference's thread run."""
    run = single_runs["sage"]
    tmp = run["tmp"]
    with RDistSession(run["rstore"], shards=2, config=RConfig(**_cfg()),
                      workdir=str(tmp / "rproc")) as dist:
        want = dist.infer(run["specs"]).shard_reports
    with DistSession(run["tstore"], shards=2, workers="process",
                     config=AtlasConfig(backend="cpu", **_cfg()),
                     workdir=str(tmp / "tproc")) as dist:
        res = dist.infer(_port_specs(run["specs"]))
    np.testing.assert_array_equal(_final(res, V), run["ref"])
    for layer, reports in res.shard_reports.items():
        assert [r["exchange"] for r in reports] == [r["exchange"] for r in want[layer]]


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_mesh_exchange_on_cpu_devices(single_runs, kind):
    """exchange='mesh' over ["cpu", "cpu"]: device copies are pure data
    movement, so the spills equal the single machine's and the local
    exchange's traffic."""
    run = single_runs[kind]
    with DistSession(run["tstore"], shards=2, exchange="mesh", mesh_devices=["cpu", "cpu"],
                     config=AtlasConfig(backend="cpu", **_cfg()),
                     workdir=str(run["tmp"] / "mesh")) as dist:
        res = dist.infer(_port_specs(run["specs"]))
    np.testing.assert_array_equal(_final(res, V), run["ref"])
    assert all(r["exchange"]["recv_records"] > 0
               for reports in res.shard_reports.values() for r in reports)


@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu", "cpu:0", "cpu"]])
def test_mesh_exchange_routes_like_local(tmp_path, devices):
    """Hand-made buckets of uneven sizes through both exchanges: shard t
    collects from every peer the same (src, ids, rows, counts).  Three
    shards on one device take the one-device transpose; "cpu:0" is
    another torch device than "cpu", so the second list takes the
    per-destination copies."""
    s, w = 3, 5
    rng = np.random.default_rng(0)
    buckets = {
        i: {t: (np.sort(rng.choice(1000, n, replace=False)).astype(np.int64),
                rng.normal(size=(n, w)).astype(np.float32),
                rng.integers(1, 9, n).astype(np.int64))
            for t, n in ((t, int(rng.integers(0, 7))) for t in range(s)) if t != i}
        for i in range(s)
    }
    got = {}
    for name, exch in (("local", LocalExchange(str(tmp_path / "x"), s)),
                       ("mesh", MeshExchange(s, devices=devices))):
        out = [None] * s

        def work(i):
            exch.post(0, i, buckets[i])
            out[i] = exch.collect(0, i)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(s)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        got[name] = out
    for t in range(s):
        local = sorted(got["local"][t], key=lambda b: b[0])
        mesh = sorted(got["mesh"][t], key=lambda b: b[0])
        assert [b[0] for b in mesh] == [b[0] for b in local] == [
            i for i in range(s) if i != t and len(buckets[i][t][0])]
        for a, b in zip(mesh, local):
            for x, y in zip(a[1:], b[1:]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_mesh_exchange_device_list(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"needs >= 2 CUDA devices.*'cpu'"):
        MeshExchange(2)
    with pytest.raises(ValueError, match="one device per shard"):
        MeshExchange(2, devices=["cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshExchange(2, devices=["cuda:0", "cuda:0"])
    assert make_exchange("mesh", "", 2, devices=["cpu", "cpu"]).devices == [
        torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="unknown exchange"):
        make_exchange("grpc", "", 2)


# --------------------------------------------------------------------------
# gather baselines
# --------------------------------------------------------------------------


GATHERS = [("layerwise_gather", 256), ("vertexwise_gather", 200)]


@pytest.mark.parametrize("fn,batch", GATHERS)
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_gather_exact_matches_reference(fn, batch, kind):
    csr, feats, specs = exact_graph_and_specs(700, D, kind=kind)
    want, wstats = getattr(r_gather, fn)(csr, feats, specs, batch_size=batch)
    got, gstats = getattr(t_gather, fn)(csr, feats, _port_specs(specs), batch_size=batch,
                                        device="cpu")
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)


def test_gather_exact_gin_matches_reference():
    csr, feats, _ = exact_graph_and_specs(500, D, kind="gcn")
    specs = int_gin_specs([D, 12, 4], seed=3)
    for fn, batch in GATHERS:
        want, wstats = getattr(r_gather, fn)(csr, feats, specs, batch_size=batch)
        got, gstats = getattr(t_gather, fn)(csr, feats, _port_specs(specs),
                                            batch_size=batch, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)


@pytest.mark.parametrize("fn,batch", GATHERS)
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_gather_powerlaw_matches_reference(fn, batch, kind):
    csr = powerlaw_graph(900, 6, seed=1, self_loops=(kind == "gcn"))
    feats = make_features(900, 16, seed=2)
    specs = rgnn.init_gnn_params(kind, [16, 24, 8], seed=3, gin_eps=0.25)
    want, wstats = getattr(r_gather, fn)(csr, feats, specs, batch_size=batch)
    got, gstats = getattr(t_gather, fn)(csr, feats, _port_specs(specs), batch_size=batch,
                                        device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)
    # the baselines compute what the dense oracle computes
    ref = tgnn.dense_reference(csr, feats, _port_specs(specs), device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row_bytes,block_bytes", [(32, 4096), (3000, 4096), (4096, 512)])
def test_block_accountant_matches_reference(row_bytes, block_bytes):
    rng = np.random.default_rng(row_bytes)
    for n in (0, 1, 50, 3000):
        rows = rng.integers(0, 20_000, n)
        assert t_gather.BlockAccountant(row_bytes, block_bytes).bytes_for_rows(rows) == \
            r_gather.BlockAccountant(row_bytes, block_bytes).bytes_for_rows(rows)


def test_gather_raises_for_cuda_without_a_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr, feats, specs = exact_graph_and_specs(64, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_gather.layerwise_gather(csr, feats, _port_specs(specs))


# --------------------------------------------------------------------------
# trace report
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A traced single-machine run of the port and a traced 2-shard run."""
    tmp = tmp_path_factory.mktemp("trace")
    csr = powerlaw_graph(1200, 8, seed=1)
    store = GraphStore.create(str(tmp / "store"), csr, make_features(1200, 16, seed=2))
    specs = tgnn.init_gnn_params("sage", [16, 24, 8], seed=3)
    cfg = AtlasConfig(backend="cpu", trace=True, **_cfg())
    with AtlasSession(store, config=cfg, workdir=str(tmp / "single")) as s:
        res = s.infer(specs)
    with DistSession(store, shards=2, config=cfg, workdir=str(tmp / "dist")) as d:
        dres = d.infer(specs)
    return res, dres


def test_obs_report_gives_reference_answer_on_port_trace(port_trace):
    res, _ = port_trace
    events = t_obs.load_trace(res.trace_path)
    assert events == r_obs.load_trace(res.trace_path)
    assert t_obs.validate_trace(events) == r_obs.validate_trace(events) == []
    report = t_obs.analyze(events)
    assert report == r_obs.analyze(events)
    assert len(report["layers"]) == 2 and report["num_spans"] > 0
    layers = res.telemetry["layers"]
    assert t_obs.reconcile(report, layers) == r_obs.reconcile(report, layers)
    assert t_obs.RECONCILE == r_obs.RECONCILE
    # every metric the map names is a LayerMetrics field of the port
    assert set(t_obs.RECONCILE) <= set(layers[0])


def test_stall_metrics_time_their_spans():
    """The two waits the trace files under ``stall`` — the staging ring's
    ``ring_wait`` and the graduation buffer's ``emit_wait`` — are the
    regions ``pipeline_stall_seconds`` sums, so reconcile can hold them
    to 5 %."""
    import time
    import types

    from repro_torch.core.graduation import GraduationProcessor
    from repro_torch.core.staging import StagedAggregation
    from repro_torch.obs.trace import Tracer

    def slow(x):
        time.sleep(0.02)
        return x

    tr = Tracer()
    grad = GraduationProcessor(transform=slow, sink=lambda ids, rows: None, dim=4,
                               dtype=np.float32, buffer_rows=4, queue_depth=1, tracer=tr)
    for i in range(8):
        grad.add(np.arange(4 * i, 4 * i + 4, dtype=np.uint64), np.ones((4, 4), np.float32))
    grad.close()
    emit_wait = sum(sp["dur_s"] for sp in tr.spans() if sp["name"] == "emit_wait")
    assert grad.stall_seconds > 0.02
    assert grad.stall_seconds == pytest.approx(emit_wait, rel=0.05, abs=2e-3)

    tr = Tracer()
    chunks = (types.SimpleNamespace(index=i, feats=np.zeros((1, 1), np.float32))
              for i in range(5))
    pipe = StagedAggregation(chunks, lambda c: (None, None, None),
                             lambda *args: slow(None), depth=1, tracer=tr)
    assert len(list(pipe)) == 5
    ring_wait = sum(sp["dur_s"] for sp in tr.spans() if sp["name"] == "ring_wait")
    assert pipe.stall_seconds > 0.05
    assert pipe.stall_seconds == pytest.approx(ring_wait, rel=0.05, abs=2e-3)


def test_obs_report_on_dist_trace(port_trace):
    _, dres = port_trace
    events = t_obs.load_trace(dres.trace_path)
    assert t_obs.validate_trace(events) == r_obs.validate_trace(events) == []
    report = t_obs.analyze(events)
    assert report == r_obs.analyze(events)
    # one layer span per shard per layer, and the exchange barrier traced
    assert sorted(l["name"] for l in report["layers"]) == sorted(
        f"layer_{l}_s{s}" for l in range(2) for s in range(2))
    assert report["category_seconds"].get("barrier", 0.0) > 0


def test_obs_report_cli(port_trace, tmp_path):
    res, _ = port_trace
    telemetry = tmp_path / "telemetry.json"
    telemetry.write_text(json.dumps(res.telemetry))
    out_json = tmp_path / "report.json"
    rc = t_obs.main([res.trace_path, "--telemetry", str(telemetry), "--json", str(out_json)])
    assert rc == 0  # without --check, mismatches are reported, not fatal
    written = json.loads(out_json.read_text())
    assert len(written["layers"]) == 2
    assert written["violations"] == r_obs.reconcile(
        r_obs.analyze(r_obs.load_trace(res.trace_path)), res.telemetry["layers"])
    # a broken trace is a schema violation under --check
    broken = tmp_path / "broken.json"
    events = r_obs.load_trace(res.trace_path)
    broken.write_text(json.dumps([e for e in events if e.get("ph") != "E"]))
    assert t_obs.main([str(broken), "--check"]) == 1
