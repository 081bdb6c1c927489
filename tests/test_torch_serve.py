"""The port's publish and serving slice (``AtlasSession.publish`` /
``reader`` / ``gc``, ``repro_torch.serve_gnn``, the batching front end,
the GNN launcher and the examples) against the JAX package's.

Cross-package tests run the reference (``backend="numpy"``) and the port
(``backend="cpu"``) on the same numpy inputs; on ``repro.exact`` graphs
every sum is exact in any order, so served rows compare with
``array_equal``.  The on-disk formats are the reference's, so stores,
versions and leases are checked in both directions.  The rest replays
the reference's own serving contracts (``tests/test_session.py``,
``tests/test_serving_tier.py``, ``tests/test_serve_gnn.py``) against the
port at the reference's sizes.
"""

import gc
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

try:  # the property test sweeps a fixed grid; hypothesis widens it when present
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro import exact as rexact
from repro.core.atlas import AtlasConfig as RConfig
from repro.core.atlas import spills_to_dense as r_dense
from repro.graphs.csr import CSRGraph as RCSRGraph
from repro.session import AtlasSession as RSession
from repro.storage.layout import GraphStore as RStore
from repro_torch.core.atlas import AtlasConfig, AtlasEngine, spills_to_dense
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.synth import make_features, powerlaw_graph
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn import init_gnn_params
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.serve_gnn import (
    ServableLayer,
    ShardedPageCache,
    VertexQueryEngine,
    compact_spills,
)
from repro_torch.serve_gnn.leases import (
    PinLease,
    lease_dir,
    list_leases,
    live_leases,
    pid_alive,
    reap_stale,
)
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.session import AtlasSession
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.layout import GraphStore
from repro_torch.storage.spill import SpillSet, write_spill

from tests.test_torch_gnn import _as_dicts, int_gin_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_LAYER = 1


def scattered_spillset(
    tmp, rng, num_vertices, dim, n_files, tag="sc", shift=0.0, ids=None
):
    """Engine-shaped spill set: every vertex exactly once, scattered
    across files with interleaving id ranges.  Row j belongs to vertex
    ``ids[j]`` (default ``j``)."""
    if ids is None:
        ids = np.arange(num_vertices, dtype=np.int64)
    perm = rng.permutation(num_vertices)
    rows = rng.standard_normal((num_vertices, dim)).astype(np.float32)
    if shift:
        rows += np.float32(shift)
    ss = SpillSet()
    bounds = np.linspace(0, num_vertices, n_files + 1).astype(int)
    for i in range(n_files):
        sel = perm[bounds[i] : bounds[i + 1]]
        if len(sel):
            ss.add(
                write_spill(
                    str(tmp / f"{tag}{i}.spill"),
                    ids[sel].astype(np.uint64),
                    rows[sel],
                    block_rows=64,
                )
            )
    return ss, rows


def indexed_spillset(tmp, rng, num_vertices, dim, n_files, sparse=False):
    """``scattered_spillset``, optionally over non-contiguous ids;
    returns ``{vertex id: row}``."""
    ids = np.arange(num_vertices, dtype=np.int64)
    if sparse:
        ids = np.sort(rng.choice(4 * num_vertices, num_vertices, replace=False))
    ss, rows = scattered_spillset(tmp, rng, num_vertices, dim, n_files, ids=ids)
    return ss, {int(i): row for i, row in zip(ids, rows)}


PACKAGES = {  # (GraphStore, CSRGraph, AtlasSession) of each package
    "reference": (RStore, RCSRGraph, RSession),
    "port": (GraphStore, CSRGraph, AtlasSession),
}


def minimal_store(package, root, num_vertices):
    """A store with no edges, built by ``package`` — for publish/reader
    tests that don't need an engine run."""
    store_cls, csr_cls, _ = PACKAGES[package]
    csr = csr_cls(
        indptr=np.zeros(num_vertices + 1, dtype=np.int64),
        indices=np.empty(0, dtype=np.int64),
    )
    return store_cls.create(
        root, csr, np.zeros((num_vertices, 1), dtype=np.float32),
        num_partitions=1,
    )


def serving_session(tmp_path, num_vertices, **kwargs):
    """A port session over a minimal store."""
    store = minimal_store("port", str(tmp_path / "store"), num_vertices)
    return AtlasSession(store, workdir=str(tmp_path / "run"), **kwargs)


def build_store(tmp_path, csr, feats, num_partitions=4):
    return GraphStore.create(
        str(tmp_path / "store"), csr, feats, num_partitions=num_partitions
    )


# --------------------------------------------------------------------------
# Across packages: served rows, version files, interchange, leases
# --------------------------------------------------------------------------

EXACT_V, EXACT_D = 512, 8


def _infer_and_publish_both(tmp_path, order, kind):
    """infer → publish of one ``repro.exact`` case in both packages, each
    on its own store built under ``order``; returns the two open
    sessions and the published layer.  gin takes integer MLP weights
    (``int_gin_specs``) on the same kind of graph."""
    if kind == "gin":
        csr = rexact.pow_degree_graph(EXACT_V, (4, 16), seed=7, self_loops=True)
        feats = rexact.int_features(EXACT_V, EXACT_D, seed=8)
        specs = int_gin_specs([EXACT_D, EXACT_D, 4], seed=9)
    else:
        csr, feats, specs = rexact.exact_graph_and_specs(EXACT_V, EXACT_D, kind=kind)
    cfg = dict(chunk_bytes=96 * EXACT_D * 4, hot_slots=96)
    rstore = RStore.create(str(tmp_path / "r"), csr, feats, num_partitions=4,
                           order=order)
    tstore = GraphStore.create(str(tmp_path / "t"), csr, feats,
                               num_partitions=4, order=order)
    rs = RSession(rstore, config=RConfig(backend="numpy", **cfg))
    ts = AtlasSession(tstore, config=AtlasConfig(backend="cpu", **cfg))
    rs.publish(rs.infer(specs).final)
    port_specs = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    final = ts.infer(port_specs).final
    ts.publish(final)
    assert final.num_rows == EXACT_V and sum(m.evictions for m in ts._last_result.metrics)
    return rs, ts, final


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("order", ["og", "rnd", "at"])
def test_served_rows_equal_reference(tmp_path, order, kind):
    """Rows the port serves by external id are the reference's, bit for
    bit, on every reader path and cache budget, and both equal the
    engine's dense output at the store's permutation."""
    rs, ts, final = _infer_and_publish_both(tmp_path, order, kind)
    dense = spills_to_dense(final.spills, EXACT_V, final.dim)
    new_of_old = ts.store.new_of_old()
    assert (new_of_old is None) == (order == "og")
    ids = np.random.default_rng(3).integers(0, EXACT_V, size=700)
    expect = dense[ids if new_of_old is None else new_of_old[ids]]
    data = EXACT_V * final.dim * 4
    for fast_path in (True, False, "auto"):
        for cache_bytes in (data // 8, 2 * data):
            with ts.reader(final.layer, fast_path=fast_path,
                           cache_bytes=cache_bytes) as tr, \
                    rs.reader(final.layer, fast_path=fast_path,
                              cache_bytes=cache_bytes) as rr:
                assert tr.fast_path == rr.fast_path
                if fast_path == "auto":
                    assert tr.fast_path == (cache_bytes >= data)
                got, ref = tr.lookup(ids), rr.lookup(ids)
                assert got.dtype == ref.dtype == np.float32
                assert np.array_equal(got, ref)
                assert np.array_equal(got, expect)
                assert tr.blocks_read == rr.blocks_read
    rs.close()
    ts.close()


def _serving_pair(tmp_path, v, **kwargs):
    """(reference session, port session) over two minimal stores."""
    return [
        PACKAGES[pkg][2](minimal_store(pkg, str(tmp_path / pkg / "store"), v),
                         workdir=str(tmp_path / pkg / "run"), **kwargs)
        for pkg in ("reference", "port")
    ]


def _version_tree(version_dir):
    out = {}
    for dirpath, dirnames, filenames in os.walk(version_dir):
        dirnames[:] = [d for d in dirnames if d != ".leases"]
        for name in filenames:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, version_dir)] = f.read()
    return out


@pytest.mark.parametrize("block_rows,rows_per_file", [(64, None), (32, 100), (128, 333)])
def test_published_version_files_byte_identical(tmp_path, block_rows, rows_per_file):
    """Same spills, same clock: the two packages write the same version
    files byte for byte, and the same ``servable_layers`` manifest entry
    once each store's root is taken out of its paths."""
    v, d = 700, 12
    ss, _ = scattered_spillset(tmp_path, np.random.default_rng(block_rows), v, d, 4)
    rs, ts = _serving_pair(tmp_path, v, clock=lambda: 1234.5)
    entries = []
    for session in (rs, ts):
        pubs = [session.publish(SERVE_LAYER, spills=ss, block_rows=block_rows,
                                rows_per_file=rows_per_file, retain=1)
                for _ in range(3)]
        assert [p.gc_removed for p in pubs] == [(), (), (1,)]
        root = session.store.root
        entry = json.dumps(session.store.manifest["servable_layers"],
                           sort_keys=True)
        entries.append((entry.replace(root, "<root>"), pubs))
    (r_entry, r_pubs), (t_entry, t_pubs) = entries
    assert r_entry == t_entry
    for rp, tp in zip(r_pubs[1:], t_pubs[1:]):
        assert (rp.epoch, rp.num_rows, rp.dim) == (tp.epoch, tp.num_rows, tp.dim)
        r_tree, t_tree = _version_tree(rp.dir), _version_tree(tp.dir)
        assert r_tree and r_tree.keys() == t_tree.keys()
        for name in r_tree:
            assert r_tree[name] == t_tree[name], name
    rs.close()
    ts.close()


def _sessions_on_one_store(tmp_path, v, publisher):
    """A publishing session of one package and a reading session of the
    other, both on one store (created by the publisher's package)."""
    reader = "port" if publisher == "reference" else "reference"
    root = minimal_store(publisher, str(tmp_path / "store"), v).root
    return (PACKAGES[publisher][2](root, workdir=str(tmp_path / "pub")),
            PACKAGES[reader][2](root, workdir=str(tmp_path / "read")))


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_versions_interchange_between_packages(tmp_path, publisher):
    """A version one package publishes is served by the other's reader,
    on both reader paths, with the same rows."""
    v, d = 600, 8
    rng = np.random.default_rng(21)
    ss, rows = scattered_spillset(tmp_path, rng, v, d, 3)
    pub, read = _sessions_on_one_store(tmp_path, v, publisher)
    p1 = pub.publish(SERVE_LAYER, spills=ss, block_rows=32, rows_per_file=250)
    q = rng.integers(0, v, size=400)
    for fast_path in (True, False):
        with read.reader(SERVE_LAYER, fast_path=fast_path,
                         cache_bytes=None if fast_path else 1 << 16) as r:
            assert r.version == p1.epoch and r.fast_path == fast_path
            assert np.array_equal(r.lookup(q), rows[q])
            assert np.array_equal(r.lookup(np.arange(v)), rows)
    # and the reader's side publishes on top: the other package reads it
    p2 = read.publish(SERVE_LAYER, spills=ss, block_rows=64)
    assert p2.epoch == p1.epoch + 1 and p2.gc_removed == (p1.epoch,)
    with pub.reader(SERVE_LAYER) as r:
        assert r.version == p2.epoch
        assert np.array_equal(r.lookup(q), rows[q])
    pub.close()
    read.close()


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_leases_pin_across_packages(tmp_path, publisher):
    """A reader of one package pins its version against the other
    package's publish-time and on-demand GC; once it closes, the version
    is collected."""
    v, d = 300, 8
    rng = np.random.default_rng(22)
    ss1, rows1 = scattered_spillset(tmp_path, rng, v, d, 3, tag="a")
    ss2, _ = scattered_spillset(tmp_path, rng, v, d, 3, tag="b", shift=1.0)
    pub, read = _sessions_on_one_store(tmp_path, v, publisher)
    p1 = pub.publish(SERVE_LAYER, spills=ss1, block_rows=64)
    r = read.reader(SERVE_LAYER, fast_path=True)
    assert r.version == p1.epoch and len(list_leases(p1.dir)) == 1
    p2 = pub.publish(SERVE_LAYER, spills=ss2, block_rows=64)
    assert p1.epoch not in p2.gc_removed
    assert pub.gc(SERVE_LAYER) == []
    assert os.path.isdir(p1.dir)
    assert np.array_equal(r.lookup(np.arange(v)), rows1)
    r.close()
    assert list_leases(p1.dir) == []
    assert pub.gc(SERVE_LAYER) == [p1.epoch]
    assert not os.path.exists(p1.dir)
    pub.close()
    read.close()


def test_failed_publish_retires_the_write_back_scheduler(tmp_path):
    """A failed publish closes the session's write-back scheduler without
    its commit; the next publish starts a fresh one and lands."""
    v = 200
    rng = np.random.default_rng(23)
    ss, rows = scattered_spillset(tmp_path, rng, v, 4, 2)
    bad = SpillSet()
    bad.add(ss.files[0])
    bad.add(ss.files[0])  # duplicate rows -> compaction raises
    session = serving_session(tmp_path, v)
    session.publish(SERVE_LAYER, spills=ss)
    first = session._io_sched
    assert first is not None and not first.closed
    with pytest.raises(ValueError, match="duplicate"):
        session.publish(SERVE_LAYER, spills=bad)
    assert first.closed and session._io_sched is None
    pub = session.publish(SERVE_LAYER, spills=ss)
    assert session._io_sched is not None and session._io_sched is not first
    with session.reader(SERVE_LAYER) as r:
        assert r.version == pub.epoch
        assert np.array_equal(r.lookup(np.arange(v)), rows)
    session.close()
    assert session._io_sched is None


# --------------------------------------------------------------------------
# The reference's session contracts, replayed against the port
# --------------------------------------------------------------------------


def test_reader_pinned_across_concurrent_republish(tmp_path):
    """A reader opened before a re-publish returns bit-identical rows to
    spills_to_dense of its pinned version while another thread
    republishes the same layer — never mixed-version, never missing."""
    v, d = 800, 8
    rng = np.random.default_rng(0)
    session = serving_session(tmp_path, v)
    ss_a, _ = scattered_spillset(tmp_path, rng, v, d, n_files=5, tag="a")
    ss_b, _ = scattered_spillset(tmp_path, rng, v, d, n_files=4, tag="b", shift=1.0)
    ref_a = spills_to_dense(ss_a, v, d)
    session.publish(1, spills=ss_a, rows_per_file=200, block_rows=32)

    reader = session.reader(1, cache_bytes=1 << 20)
    pinned = reader.version
    done = threading.Event()
    publish_errors = []

    def republish_loop():
        try:
            for i in range(5):
                ss = ss_b if i % 2 == 0 else ss_a
                session.publish(1, spills=ss, rows_per_file=150, block_rows=16)
        except Exception as e:  # noqa: BLE001
            publish_errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=republish_loop)
    t.start()
    checks = 0
    while not done.is_set() or checks < 20:
        q = rng.integers(0, v, size=96)
        got = reader.lookup(q)
        assert np.array_equal(got, ref_a[q]), "pinned reader saw foreign rows"
        checks += 1
        if checks > 10_000:  # pragma: no cover - watchdog
            break
    t.join()
    assert not publish_errors
    assert checks >= 20
    # full-sweep still bit-identical to the pinned version's materialisation
    assert np.array_equal(reader.lookup(np.arange(v)), ref_a)
    store = session.store
    assert pinned in store.servable_versions(1)  # survived every re-publish
    reader.close()
    session.publish(1, spills=ss_a)  # GC happens on the next publish
    assert pinned not in store.servable_versions(1)
    session.close()


def test_publish_gc_drops_unpinned_keeps_pinned(tmp_path):
    v, d = 400, 4
    rng = np.random.default_rng(1)
    session = serving_session(tmp_path, v)
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=3)
    p1 = session.publish(1, spills=ss, rows_per_file=128)
    r1 = session.reader(1)  # pins epoch 1
    p2 = session.publish(1, spills=ss, rows_per_file=64)
    # epoch 1 pinned -> survives; after another publish epoch 2 (unpinned,
    # stale) is collected, epoch 1 still survives
    assert session.store.servable_versions(1) == [p1.epoch, p2.epoch]
    p3 = session.publish(1, spills=ss)
    assert p2.epoch in p3.gc_removed
    assert session.store.servable_versions(1) == [p1.epoch, p3.epoch]
    assert os.path.isdir(p1.dir) and not os.path.exists(p2.dir)
    # two readers on one version: closing one keeps the pin
    r1b = session.reader(1, epoch=p1.epoch)
    r1.close()
    session.publish(1, spills=ss)
    assert p1.epoch in session.store.servable_versions(1)
    assert np.array_equal(
        r1b.lookup(np.arange(v)), spills_to_dense(ss, v, d)
    )
    r1b.close()
    final = session.publish(1, spills=ss)
    assert session.store.servable_versions(1) == [final.epoch]
    assert session.pinned_versions(1) == {}
    session.close()


def test_publish_retain_keeps_newest_unpinned_history(tmp_path):
    """publish(retain=N) keeps at most N unpinned historical versions —
    the newest ones — and still never touches pinned or current ones."""
    v, d = 300, 4
    rng = np.random.default_rng(9)
    session = serving_session(tmp_path, v)
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    pubs = [session.publish(1, spills=ss, retain=2) for _ in range(5)]
    # current epoch 5 + the two newest historical (3, 4); 1 and 2 GC'd
    # one at a time as the history window slid past them
    assert session.store.servable_versions(1) == [3, 4, 5]
    assert pubs[3].gc_removed == (1,)
    assert pubs[-1].gc_removed == (2,)
    for p in pubs[:2]:
        assert not os.path.exists(p.dir)
    for p in pubs[2:]:
        assert os.path.isdir(p.dir)
    # historical (non-current) retained versions stay openable
    with session.reader(1, epoch=3) as r:
        assert np.array_equal(r.lookup(np.arange(v)), spills_to_dense(ss, v, d))
    # shrinking retain on the next publish collects the surplus
    session.publish(1, spills=ss, retain=1)
    assert session.store.servable_versions(1) == [5, 6]
    session.close()
    assert session.store.servable_versions(1) == [6]


def test_publish_retain_pinned_versions_do_not_count(tmp_path):
    """A version pinned by an open reader survives regardless of retain
    and does not consume the retain budget."""
    v, d = 250, 4
    rng = np.random.default_rng(10)
    session = serving_session(tmp_path, v)
    ss, rows = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    p1 = session.publish(1, spills=ss, retain=1)
    r1 = session.reader(1)  # pins epoch 1
    for _ in range(3):
        session.publish(1, spills=ss, retain=1)
    # epoch 1: pinned.  epoch 3: the one retained unpinned historical.
    # epoch 4: current.  epoch 2 was collected despite retain=1 because
    # pinned epoch 1 does not consume the budget.
    assert session.store.servable_versions(1) == [1, 3, 4]
    assert np.array_equal(r1.lookup(np.arange(v)), spills_to_dense(ss, v, d))
    r1.close()
    # with the pin gone, epoch 1 is plain history: newest-first retention
    # keeps epoch 3 and collects it
    session.publish(1, spills=ss, retain=1)
    assert session.store.servable_versions(1) == [4, 5]
    assert not os.path.exists(p1.dir)
    session.close()


def test_gc_retain_without_publish(tmp_path):
    """session.gc(layer, retain=N) applies the same policy on demand."""
    v, d = 200, 4
    rng = np.random.default_rng(11)
    session = serving_session(tmp_path, v)
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    for _ in range(4):
        session.publish(1, spills=ss, retain=10)  # keep everything
    assert session.store.servable_versions(1) == [1, 2, 3, 4]
    removed = session.gc(1, retain=1)
    assert sorted(removed) == [1, 2]
    assert session.store.servable_versions(1) == [3, 4]
    session.close()


def test_publish_retain_ttl_age_based_gc(tmp_path):
    """publish(retain_ttl=seconds): historical versions younger than the
    TTL (by their recorded published_at) survive, older ones are
    collected — driven by an injected clock, no sleeps."""
    v, d = 200, 4
    rng = np.random.default_rng(12)
    now = [1000.0]
    session = serving_session(tmp_path, v, clock=lambda: now[0])
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    session.publish(1, spills=ss, retain_ttl=60.0)           # epoch 1 @ t=1000
    now[0] = 1030.0
    session.publish(1, spills=ss, retain_ttl=60.0)           # epoch 2 @ t=1030
    # epoch 1 is 30s old < 60s TTL -> kept
    assert session.store.servable_versions(1) == [1, 2]
    now[0] = 1070.0
    p3 = session.publish(1, spills=ss, retain_ttl=60.0)      # epoch 3 @ t=1070
    # epoch 1 is now 70s old -> collected; epoch 2 (40s) survives
    assert p3.gc_removed == (1,)
    assert session.store.servable_versions(1) == [2, 3]
    # retain=N composes: the newest N unpinned historicals are exempt
    # from the age check
    now[0] = 2000.0
    session.publish(1, spills=ss, retain=1, retain_ttl=60.0)
    assert session.store.servable_versions(1) == [3, 4]
    # on-demand gc applies the same age policy
    now[0] = 3000.0
    removed = session.gc(1, retain_ttl=60.0)
    assert removed == [3]
    assert session.store.servable_versions(1) == [4]
    # pinned versions never age out
    r = session.reader(1)  # pins epoch 4
    now[0] = 9000.0
    session.publish(1, spills=ss, retain_ttl=1.0)            # epoch 5
    assert session.store.servable_versions(1) == [4, 5]
    r.close()
    session.close()


def test_publish_retain_ttl_missing_timestamp_is_old(tmp_path):
    """Versions published before the published_at field existed (no
    timestamp in the manifest) count as infinitely old under a TTL."""
    v, d = 150, 4
    rng = np.random.default_rng(13)
    now = [500.0]
    session = serving_session(tmp_path, v, clock=lambda: now[0])
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    p1 = session.publish(1, spills=ss)
    # simulate a pre-TTL-era manifest entry: drop its published_at
    info = session.store.servable_version_info(1, p1.epoch)
    info.pop("published_at", None)
    session.store._write_manifest()
    p2 = session.publish(1, spills=ss, retain_ttl=1e9)
    assert p2.gc_removed == (p1.epoch,)
    assert session.store.servable_versions(1) == [p2.epoch]
    session.close()


def test_publish_sweeps_orphan_version_dirs(tmp_path):
    """A crash between un-recording a version and deleting its files
    leaves an orphan v<epoch>/ dir; the next publish reclaims it (epochs
    are never reused, so nothing else could)."""
    v, d = 200, 4
    rng = np.random.default_rng(7)
    session = serving_session(tmp_path, v)
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    p1 = session.publish(1, spills=ss)
    base = os.path.dirname(p1.dir)
    orphan = os.path.join(base, "v000099")
    stale_staging = os.path.join(base, "v000098.compact")
    for d_ in (orphan, stale_staging):
        os.makedirs(d_)
        with open(os.path.join(d_, "junk.spill"), "w") as f:
            f.write("x")
    p2 = session.publish(1, spills=ss)
    assert not os.path.exists(orphan) and not os.path.exists(stale_staging)
    assert os.path.isdir(p2.dir)  # recorded versions untouched
    with session.reader(1) as r:
        assert np.array_equal(r.lookup(np.arange(v)), spills_to_dense(ss, v, d))
    session.close()


def test_session_close_collects_stale_versions(tmp_path):
    v, d = 300, 4
    rng = np.random.default_rng(2)
    session = serving_session(tmp_path, v)
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=2)
    session.publish(1, spills=ss)
    reader = session.reader(1)
    session.publish(1, spills=ss)
    assert len(session.store.servable_versions(1)) == 2  # v1 pinned
    session.close()  # closes the leaked reader, then GCs
    assert len(session.store.servable_versions(1)) == 1
    assert reader._closed
    with pytest.raises(RuntimeError, match="closed"):
        session.reader(1)


def test_deprecated_shims_delegate_and_warn(tmp_path):
    v, d = 400, 8
    csr = powerlaw_graph(v, 5, seed=9, self_loops=True)
    feats = make_features(v, d, seed=9)
    specs = init_gnn_params("gcn", [d, 4], seed=9)
    store = build_store(tmp_path, csr, feats)
    cfg = AtlasConfig(chunk_bytes=64 * d * 4, hot_slots=v, backend="cpu")
    with pytest.warns(DeprecationWarning, match="AtlasSession.infer"):
        spills, metrics = AtlasEngine(cfg).run(store, specs, str(tmp_path / "w"))
    assert len(metrics) == 1
    ref = spills_to_dense(spills, v, 4)
    with pytest.warns(DeprecationWarning, match="AtlasSession.publish"):
        files = store.register_servable_layer(1, spills, block_rows=64)
    assert all(os.path.exists(p) for p in files)
    layer = ServableLayer.from_store(store, 1)
    assert layer.epoch == 1
    assert np.array_equal(VertexQueryEngine(layer).lookup(np.arange(v)), ref)
    # the shim keeps the old replace-in-place contract: re-registering
    # drops every older version with no regard for readers
    with pytest.warns(DeprecationWarning):
        store.register_servable_layer(1, spills, block_rows=32)
    assert store.servable_versions(1) == [2]
    assert store.manifest["servable_layers"]["1"]["block_rows"] == 32


def test_legacy_flat_manifest_entry_is_normalized(tmp_path):
    """Stores written before versioning (flat servable_layers entries)
    keep serving, and the first publish wraps them as epoch 1."""
    v, d = 300, 4
    rng = np.random.default_rng(4)
    session = serving_session(tmp_path, v)
    store = session.store
    ss, _ = scattered_spillset(tmp_path, rng, v, d, n_files=3)
    ref = spills_to_dense(ss, v, d)
    # write a legacy-shaped entry by hand (what pre-versioning code
    # persisted)
    out_dir = os.path.join(store.root, "servable_l1")
    files = compact_spills(ss, out_dir, rows_per_file=128, block_rows=32)
    first_dim = ss.files[0].dim
    store.manifest["servable_layers"] = {
        "1": {
            "files": files,
            "block_rows": 32,
            "num_rows": v,
            "dim": first_dim,
            "dtype": "float32",
        }
    }
    store._write_manifest()

    layer = ServableLayer.from_store(GraphStore.open(store.root), 1)
    assert layer.epoch == 1
    assert np.array_equal(VertexQueryEngine(layer).lookup(np.arange(v)), ref)
    # a session publish on top normalizes + GCs the legacy files
    pub = session.publish(1, spills=ss)
    assert pub.epoch == 2 and pub.gc_removed == (1,)
    assert store.servable_versions(1) == [2]
    assert not any(os.path.exists(p) for p in files)
    assert os.path.isdir(out_dir)  # version subdirs still live under it
    with session.reader(1) as r:
        assert np.array_equal(r.lookup(np.arange(v)), ref)
    session.close()


def test_failed_first_publish_leaves_no_phantom_entry(tmp_path):
    """A failed publish of a never-published layer must not leave a
    version-less manifest entry that later breaks opens of that layer."""
    v = 100
    rng = np.random.default_rng(6)
    session = serving_session(tmp_path, v)
    store = session.store
    ss, _ = scattered_spillset(tmp_path, rng, v, 4, n_files=2)
    bad = SpillSet()
    bad.add(ss.files[0])
    bad.add(ss.files[0])  # duplicate rows -> compaction raises
    with pytest.raises(ValueError, match="duplicate"):
        session.publish(2, spills=bad)
    # a failure after compaction (e.g. reading the landed files back)
    # must also roll the phantom entry back
    from repro_torch.storage import layout as layout_mod

    orig_open = layout_mod.SpillFile.open
    try:
        layout_mod.SpillFile.open = staticmethod(
            lambda path: (_ for _ in ()).throw(OSError("injected"))
        )
        with pytest.raises(OSError, match="injected"):
            session.publish(3, spills=ss)
    finally:
        layout_mod.SpillFile.open = orig_open
    session.publish(1, spills=ss)  # persists the manifest
    reopened = GraphStore.open(store.root)
    assert reopened.servable_layers() == [1]
    with pytest.raises(KeyError, match="not registered"):
        session.reader(2)
    # a failed RE-publish keeps the registered version serving
    with pytest.raises(ValueError, match="duplicate"):
        session.publish(1, spills=bad)
    with session.reader(1) as r:
        assert np.array_equal(r.lookup(np.arange(v)), spills_to_dense(ss, v, 4))
    session.close()


def test_resume_exposes_surviving_intermediate_layers(tmp_path):
    """With delete_intermediate off, a resumed run's RunResult carries
    handles for earlier completed layers still on disk, so they remain
    publishable."""
    csr = powerlaw_graph(300, 5, seed=8, self_loops=True)
    feats = make_features(300, 8, seed=8)
    specs = init_gnn_params("gcn", [8, 6, 4], seed=8)
    store = build_store(tmp_path, csr, feats)
    cfg = AtlasConfig(
        chunk_bytes=64 * 8 * 4, hot_slots=300, delete_intermediate=False,
        backend="cpu",
    )

    class CrashBeforeLayer1(AtlasEngine):
        def run_layer(self, *a, **kw):
            if kw.get("layer_index") == 1:
                raise KeyboardInterrupt("simulated preemption")
            return super().run_layer(*a, **kw)

    wd = str(tmp_path / "work")
    with pytest.raises(KeyboardInterrupt):
        AtlasSession(store, workdir=wd, engine=CrashBeforeLayer1(cfg)).infer(specs)
    session = AtlasSession(store, config=cfg, workdir=wd)
    result = session.infer(specs, resume=True)
    assert sorted(result.layers) == [1, 2]  # both survive on disk
    assert result.layers[1].dim == 6 and result.final.layer == 2
    pub = session.publish(1)  # the resumed-from layer is publishable
    with session.reader(1) as r:
        assert r.version == pub.epoch
        ref = spills_to_dense(result.layers[1].spills, 300, 6)
        assert np.array_equal(r.lookup(np.arange(300)), ref)
    session.close()


def test_publish_resolution_errors(tmp_path):
    v = 100
    rng = np.random.default_rng(5)
    session = serving_session(tmp_path, v)
    with pytest.raises(KeyError, match="no spills in this session"):
        session.publish(3)
    with pytest.raises(ValueError, match="empty spill set"):
        session.publish(1, spills=SpillSet())
    ss, _ = scattered_spillset(tmp_path, rng, v, 4, n_files=2)
    with pytest.raises(KeyError, match="not registered"):
        session.reader(9)
    session.publish(1, spills=ss)
    with pytest.raises(KeyError, match="no servable version 42"):
        session.reader(1, epoch=42)
    with pytest.raises(ValueError, match="current servable version"):
        session.store.drop_servable_version(1, 1)
    session.close()



# --------------------------------------------------------------------------
# The reference's serving-tier contracts: the mmap fast path, leases
# across processes, the finalizer backstop and the batching front end
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "block_rows,rows_per_file", [(64, None), (32, 100), (128, 333)]
)
def test_fast_path_bit_identity_grid(tmp_path, block_rows, rows_per_file):
    """Every layout: mmap-gathered rows == page-cache-decoded rows ==
    the source rows, for duplicated/unsorted/full-scan requests."""
    v, d = 700, 12
    rng = np.random.default_rng(block_rows)
    with serving_session(tmp_path, v) as session:
        ss, rows = scattered_spillset(tmp_path, rng, v, d, 4)
        session.publish(SERVE_LAYER, spills=ss, block_rows=block_rows,
                        rows_per_file=rows_per_file)
        with session.reader(SERVE_LAYER, fast_path=True) as fast, \
                session.reader(
                    SERVE_LAYER, fast_path=False, cache_bytes=1 << 20
                ) as oracle:
            assert fast.fast_path and fast.cache is None
            assert not oracle.fast_path
            for size in (1, 7, 64, 300):
                q = rng.integers(0, v, size=size)
                q[::3] = q[0]  # duplicates
                got, ref = fast.lookup(q), oracle.lookup(q)
                assert got.tobytes() == ref.tobytes()
                assert np.array_equal(got, rows[q])
            full = np.arange(v, dtype=np.uint64)
            assert np.array_equal(fast.lookup(full), rows)
            assert fast.mmap_gathers > 0 and fast.blocks_read == 0
            assert fast.snapshot()["fast_path"] is True


def test_fast_path_missing_ids_raise(tmp_path):
    v = 200
    rng = np.random.default_rng(0)
    with serving_session(tmp_path, v) as session:
        # only even ids present: in-range gaps + beyond-range misses
        ids = np.arange(0, v, 2, dtype=np.uint64)
        rows = rng.standard_normal((len(ids), 4)).astype(np.float32)
        ss = SpillSet()
        ss.add(write_spill(str(tmp_path / "even.spill"), ids, rows,
                           block_rows=16))
        session.publish(SERVE_LAYER, spills=ss, block_rows=16)
        with session.reader(SERVE_LAYER, fast_path=True) as fast:
            assert np.array_equal(fast.lookup(ids[:10]), rows[:10])
            with pytest.raises(KeyError):
                fast.lookup(np.array([1], dtype=np.uint64))  # gap
            with pytest.raises(KeyError):
                fast.lookup(np.array([v + 5], dtype=np.uint64))  # beyond


def test_fast_path_external_ids(tmp_path):
    """Reordered store: the mmap path translates external ids through
    the permutation sidecar exactly like the oracle."""
    v, d = 400, 8
    csr = powerlaw_graph(v, 6, seed=3)
    feats = make_features(v, d, seed=3)
    store = GraphStore.create(
        str(tmp_path / "store"), csr, feats, num_partitions=2,
        order="rnd", order_seed=1,
    )
    with AtlasSession(store, workdir=str(tmp_path / "run")) as session:
        session.publish(SERVE_LAYER, spills=store.layer0_spills(),
                        block_rows=64)
        q = np.random.default_rng(4).integers(0, v, size=150)
        with session.reader(SERVE_LAYER, fast_path=True) as fast, \
                session.reader(SERVE_LAYER, fast_path=False) as oracle:
            assert np.array_equal(fast.lookup(q), oracle.lookup(q))
            assert np.array_equal(fast.lookup(q), feats[q])


def test_reader_fast_path_auto_selection(tmp_path):
    """"auto" serves from mmaps iff the version's rows fit the budget
    and no explicit cache object was handed in."""
    v, d = 300, 8
    rng = np.random.default_rng(1)
    with serving_session(tmp_path, v) as session:
        ss, _ = scattered_spillset(tmp_path, rng, v, d, 3)
        session.publish(SERVE_LAYER, spills=ss, block_rows=64)
        data = v * d * 4
        with session.reader(SERVE_LAYER, cache_bytes=data + 1024) as r:
            assert r.fast_path and r.cache is None  # fits: mmap path
        with session.reader(SERVE_LAYER, cache_bytes=data // 4) as r:
            assert not r.fast_path and r.cache is not None  # too big
        with session.reader(SERVE_LAYER) as r:
            assert not r.fast_path  # no budget given: stay on the oracle
        with session.reader(
            SERVE_LAYER, cache_bytes=data * 2, fast_path=False
        ) as r:
            assert not r.fast_path and r.cache is not None  # explicit wins
        shared = ShardedPageCache(64, 1 << 20)
        with session.reader(SERVE_LAYER, cache=shared) as r:
            assert not r.fast_path  # explicit cache object: page-cache path
        with pytest.raises(ValueError):
            session.reader(SERVE_LAYER, cache=shared, fast_path=True)


def test_cache_metrics_registry_export(tmp_path):
    v, d = 400, 8
    rng = np.random.default_rng(2)
    registry = MetricsRegistry()
    with serving_session(tmp_path, v) as session:
        ss, rows = scattered_spillset(tmp_path, rng, v, d, 3)
        session.publish(SERVE_LAYER, spills=ss, block_rows=64)
        with session.reader(
            SERVE_LAYER, cache_bytes=1 << 20, fast_path=False,
            metrics=registry,
        ) as r:
            q = rng.integers(0, v, size=128)
            r.lookup(q)  # cold: misses
            r.lookup(q)  # warm: hits
            assert np.array_equal(r.lookup(q), rows[q])
        snap = registry.snapshot()["serve"]["cache"]
        assert snap["misses"] > 0 and snap["hits"] > 0
        assert snap["resident_bytes"]["value"] > 0
        assert snap["resident_blocks"]["value"] > 0
        # registry counters mirror the cache's own
        assert snap["hits"] == r.cache.hits
        assert snap["misses"] == r.cache.misses


def _pin_worker(store_root, ready, release, conn):
    """Child process: pin the current version via its own session, hold
    it across the parent's re-publish + GC, verify the pinned rows never
    change, then release."""
    out = {"error": None}
    try:
        with AtlasSession(store_root, lease_ttl=60.0) as session:
            with session.reader(SERVE_LAYER, fast_path=True) as reader:
                q = np.arange(0, 50, dtype=np.uint64)
                before = reader.lookup(q)
                out["version"] = int(reader.version)
                ready.set()
                if not release.wait(timeout=60):
                    raise TimeoutError("parent never released")
                after = reader.lookup(q)
                out["stable"] = bool(np.array_equal(before, after))
    except BaseException as e:  # noqa: BLE001 - report to parent
        out["error"] = f"{type(e).__name__}: {e}"
    conn.send(out)
    conn.close()


def test_child_process_pin_survives_publish_and_gc(tmp_path):
    """Acceptance: a version pinned by a reader in another process
    survives the parent's publish+GC, and is collected after release."""
    v, d = 300, 8
    rng = np.random.default_rng(7)
    with serving_session(tmp_path, v) as session:
        ss1, _ = scattered_spillset(tmp_path, rng, v, d, 3, tag="a")
        pub1 = session.publish(SERVE_LAYER, spills=ss1, block_rows=64)

        # spawn, never fork: this process holds torch's thread pools
        ctx = multiprocessing.get_context("spawn")
        ready, release = ctx.Event(), ctx.Event()
        parent_conn, child_conn = ctx.Pipe(duplex=False)
        p = ctx.Process(
            target=_pin_worker,
            args=(session.store.root, ready, release, child_conn),
            daemon=True,
        )
        p.start()
        child_conn.close()
        assert ready.wait(timeout=60), "child never pinned"

        # re-publish: GC must skip v1 — it is pinned only by the CHILD
        # process's lease (this session holds no pin on it)
        ss2, _ = scattered_spillset(tmp_path, rng, v, d, 3, tag="b",
                                    shift=1.0)
        pub2 = session.publish(SERVE_LAYER, spills=ss2, block_rows=64)
        assert pub1.epoch not in pub2.gc_removed
        assert os.path.isdir(pub1.dir)
        assert pub1.epoch in session.store.servable_versions(SERVE_LAYER)
        assert live_leases(pub1.dir, ttl=60.0)

        release.set()
        report = parent_conn.recv()
        p.join(timeout=60)
        assert report["error"] is None, report["error"]
        assert report["version"] == pub1.epoch
        assert report["stable"], "pinned rows changed under the child"

        # child released its lease: v1 is collectable now
        assert session.gc(SERVE_LAYER) == [pub1.epoch]
        assert not os.path.exists(pub1.dir)


def test_dead_pid_lease_reaped_after_ttl(tmp_path):
    """A lease from a dead process protects its version until the TTL
    expires, then is reaped and the version collected."""
    v, d = 200, 8
    rng = np.random.default_rng(8)
    # a genuinely dead pid: a child process that already exited
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead_pid = proc.pid
    assert not pid_alive(dead_pid)

    ttl = 30.0
    with serving_session(tmp_path, v, lease_ttl=ttl) as session:
        ss1, _ = scattered_spillset(tmp_path, rng, v, d, 2, tag="a")
        pub1 = session.publish(SERVE_LAYER, spills=ss1, block_rows=64)
        lease = PinLease(pub1.dir, ttl=ttl, heartbeat=False, pid=dead_pid)

        ss2, _ = scattered_spillset(tmp_path, rng, v, d, 2, tag="b",
                                    shift=1.0)
        # fresh mtime + dead pid: NOT stale yet (TTL guards pid-observed-
        # mid-exit races) — publish-time GC keeps v1
        pub2 = session.publish(SERVE_LAYER, spills=ss2, block_rows=64)
        assert pub1.epoch not in pub2.gc_removed
        assert os.path.isdir(pub1.dir)

        # age the heartbeat past the TTL: stale (old mtime AND dead pid)
        old = time.time() - ttl - 5.0
        os.utime(lease.path, (old, old))
        assert session.gc(SERVE_LAYER) == [pub1.epoch]
        assert not os.path.exists(pub1.dir)


def test_live_pid_lease_never_reaped(tmp_path):
    """A stale heartbeat alone never loses the lease while its process
    is alive — only mtime+dead-pid does."""
    v, d = 150, 4
    rng = np.random.default_rng(9)
    ttl = 30.0
    with serving_session(tmp_path, v, lease_ttl=ttl) as session:
        ss1, _ = scattered_spillset(tmp_path, rng, v, d, 2, tag="a")
        pub1 = session.publish(SERVE_LAYER, spills=ss1, block_rows=64)
        # our own (live) pid, no heartbeat, mtime aged way past the TTL
        lease = PinLease(pub1.dir, ttl=ttl, heartbeat=False)
        old = time.time() - ttl * 10
        os.utime(lease.path, (old, old))

        ss2, _ = scattered_spillset(tmp_path, rng, v, d, 2, tag="b",
                                    shift=1.0)
        pub2 = session.publish(SERVE_LAYER, spills=ss2, block_rows=64)
        assert pub1.epoch not in pub2.gc_removed
        assert reap_stale(pub1.dir, ttl=ttl) == []
        assert len(list_leases(pub1.dir)) == 1

        lease.release()
        assert session.gc(SERVE_LAYER) == [pub1.epoch]


def test_reader_lease_lifecycle(tmp_path):
    """Opening a reader drops a heartbeated lease file in the version
    dir; close removes it."""
    v, d = 150, 4
    rng = np.random.default_rng(10)
    with serving_session(tmp_path, v) as session:
        ss, _ = scattered_spillset(tmp_path, rng, v, d, 2)
        pub = session.publish(SERVE_LAYER, spills=ss, block_rows=64)
        r = session.reader(SERVE_LAYER)
        leases = list_leases(pub.dir)
        assert len(leases) == 1 and leases[0].pid == os.getpid()
        assert os.path.dirname(leases[0].path) == lease_dir(pub.dir)
        r.close()
        assert list_leases(pub.dir) == []
        r.close()  # idempotent


def test_leaked_reader_unpinned_by_finalizer(tmp_path):
    """A reader dropped without close() releases its pin and lease when
    the garbage collector reclaims it — it cannot pin a version forever."""
    v, d = 200, 8
    rng = np.random.default_rng(11)
    with serving_session(tmp_path, v) as session:
        ss1, _ = scattered_spillset(tmp_path, rng, v, d, 2, tag="a")
        pub1 = session.publish(SERVE_LAYER, spills=ss1, block_rows=64)
        r = session.reader(SERVE_LAYER, fast_path=True)
        lease_path = r._lease.path
        assert session.pinned_versions(SERVE_LAYER) == {pub1.epoch: 1}

        del r  # leaked: no close()
        gc.collect()
        assert not os.path.exists(lease_path)
        assert session.pinned_versions(SERVE_LAYER) == {}

        ss2, _ = scattered_spillset(tmp_path, rng, v, d, 2, tag="b",
                                    shift=1.0)
        pub2 = session.publish(SERVE_LAYER, spills=ss2, block_rows=64)
        assert pub1.epoch in pub2.gc_removed


def test_reload_manifest_never_clobbers_inflight_publish(tmp_path):
    """Regression: ``reader()`` re-reads the store manifest from disk
    (cross-process publish visibility) while a same-process publish is
    mutating it under only the publish lock.  An unserialized reload used
    to swap ``store.manifest`` mid-commit, stranding the commit's version
    entry on the orphaned dict — the saved manifest then lost the epoch,
    ``next_epoch`` regressed, and a later publish *reused* the epoch
    number, re-landing different rows under pinned readers' mmaps.
    Epoch monotonicity + per-version row stability must hold under a
    reader-churn/publish race."""
    v, d = 500, 8
    rng = np.random.default_rng(12)
    with serving_session(tmp_path, v) as session:
        sets, refs = [], []
        for k in range(2):
            ss, rows = scattered_spillset(
                tmp_path, rng, v, d, 3, tag=f"m{k}", shift=float(k)
            )
            sets.append(ss)
            refs.append(rows)
        session.publish(SERVE_LAYER, spills=sets[0], block_rows=64,
                        rows_per_file=128)
        stop = threading.Event()
        errors: list[str] = []

        def churn(ti):
            lrng = np.random.default_rng(100 + ti)
            try:
                while not stop.is_set():
                    # every open runs reload_manifest against the
                    # publisher's commit section
                    with session.reader(
                        SERVE_LAYER, cache_bytes=64 << 20
                    ) as r:
                        q = lrng.integers(0, v, size=32)
                        exp = refs[(r.version - 1) % 2][q]
                        if not np.array_equal(r.lookup(q), exp):
                            errors.append(f"diverged at v{r.version}")
                            stop.set()
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(f"reader {ti}: {type(e).__name__}: {e}")
                stop.set()

        threads = [
            threading.Thread(target=churn, args=(ti,)) for ti in range(4)
        ]
        for t in threads:
            t.start()
        last = 1
        try:
            for i in range(1, 80):
                if stop.is_set():
                    break
                pub = session.publish(
                    SERVE_LAYER, spills=sets[i % 2], block_rows=64,
                    rows_per_file=128,
                )
                assert pub.epoch > last, (
                    f"epoch reuse: v{pub.epoch} published after v{last}"
                )
                last = pub.epoch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not errors, errors
        assert last == 80


def test_histogram_state_roundtrip_and_merge():
    rng = np.random.default_rng(12)
    a, b = Histogram(), Histogram()
    for x in rng.exponential(0.01, size=200):
        a.observe(float(x))
    for x in rng.exponential(0.10, size=100):
        b.observe(float(x))
    restored = Histogram.from_state(a.to_state())
    assert restored.snapshot() == a.snapshot()
    merged = Histogram.from_state(a.to_state()).merge(
        Histogram.from_state(b.to_state())
    )
    ref = Histogram()
    ref.merge(a).merge(b)
    assert merged.snapshot() == ref.snapshot()
    assert merged.count == 300


class _ArrayReader:
    """Minimal lookup target: rows by index, KeyError past the end."""

    def __init__(self, rows: np.ndarray, delay_s: float = 0.0):
        self.rows = rows
        self.delay_s = delay_s
        self.calls = 0

    def lookup(self, ids):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        ids = np.asarray(ids, dtype=np.int64)
        if np.any(ids >= len(self.rows)):
            raise KeyError("missing ids")
        return self.rows[ids]


def test_frontend_correctness_across_threads():
    rng = np.random.default_rng(13)
    rows = rng.standard_normal((500, 8)).astype(np.float32)
    reader = _ArrayReader(rows)
    failures: list[str] = []

    with ServingFrontend(reader, max_batch=256, max_delay_s=0.002) as fe:
        def client(seed: int) -> None:
            r = np.random.default_rng(seed)
            for _ in range(25):
                q = r.integers(0, 500, size=int(r.integers(1, 40)))
                got = fe.lookup(q, timeout=30)
                if not np.array_equal(got, rows[q]):
                    failures.append(f"client {seed}: rows diverged")
                    return

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not failures
    assert fe.requests == 150
    snap = fe.snapshot()
    assert snap["waves"] == reader.calls
    assert snap["errors"] == 0


def test_frontend_coalesces_waves():
    """While one (slow) wave is in flight, later submits pile up and are
    served together — far fewer reader calls than requests."""
    rng = np.random.default_rng(14)
    rows = rng.standard_normal((300, 4)).astype(np.float32)
    reader = _ArrayReader(rows, delay_s=0.02)
    with ServingFrontend(reader, max_batch=10_000, max_delay_s=0.5) as fe:
        futs = [fe.submit(rng.integers(0, 300, size=16)) for _ in range(12)]
        for f in futs:
            assert np.array_equal(f.result(30), rows[f.ids])
    assert fe.waves < fe.requests  # coalescing actually happened
    assert fe.batched_ids == 12 * 16
    assert fe.unique_ids <= fe.batched_ids


def test_frontend_error_isolation():
    """A request with missing ids fails alone; wave-mates still get rows."""
    rng = np.random.default_rng(15)
    rows = rng.standard_normal((100, 4)).astype(np.float32)
    reader = _ArrayReader(rows, delay_s=0.02)
    with ServingFrontend(reader, max_batch=10_000, max_delay_s=0.5) as fe:
        good1 = fe.submit(np.arange(10))
        bad = fe.submit(np.array([5, 999]))  # 999 is missing
        good2 = fe.submit(np.arange(20, 30))
        assert np.array_equal(good1.result(30), rows[:10])
        with pytest.raises(KeyError):
            bad.result(30)
        assert np.array_equal(good2.result(30), rows[20:30])
    assert fe.errors == 1


def test_frontend_deadline_flushes_sparse_traffic():
    """A single tiny request is served within ~max_delay_s even though
    max_batch is never reached."""
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    reader = _ArrayReader(rows)
    with ServingFrontend(reader, max_batch=10_000, max_delay_s=0.02) as fe:
        t0 = time.perf_counter()
        got = fe.lookup(np.array([3]), timeout=10)
        assert time.perf_counter() - t0 < 5.0
        assert np.array_equal(got, rows[[3]])


def test_frontend_stop_drains_and_refuses():
    rng = np.random.default_rng(16)
    rows = rng.standard_normal((200, 4)).astype(np.float32)
    reader = _ArrayReader(rows, delay_s=0.005)
    fe = ServingFrontend(reader, max_batch=32, max_delay_s=0.5).start()
    futs = [fe.submit(rng.integers(0, 200, size=8)) for _ in range(10)]
    fe.stop()
    for f in futs:  # stop() drained everything already queued
        assert f.done
        assert np.array_equal(f.result(0), rows[f.ids])
    with pytest.raises(RuntimeError):
        fe.submit(np.array([1]))


def test_frontend_over_session_reader(tmp_path):
    """End to end: frontend waves against a pinned fast-path reader are
    bit-identical to direct lookups."""
    v, d = 300, 8
    rng = np.random.default_rng(17)
    with serving_session(tmp_path, v) as session:
        ss, rows = scattered_spillset(tmp_path, rng, v, d, 3)
        session.publish(SERVE_LAYER, spills=ss, block_rows=64)
        with session.reader(SERVE_LAYER, fast_path=True) as reader, \
                ServingFrontend(reader, max_batch=128,
                                max_delay_s=0.002) as fe:
            futs = [fe.submit(rng.integers(0, v, size=24))
                    for _ in range(20)]
            for f in futs:
                assert np.array_equal(f.result(30), rows[f.ids])
        assert fe.waves >= 1



# --------------------------------------------------------------------------
# The reference's read-path contracts: compaction, page cache, queries
# --------------------------------------------------------------------------


def test_compaction_produces_disjoint_indexed_files(tmp_path):
    rng = np.random.default_rng(0)
    ss, _ = indexed_spillset(tmp_path, rng, 900, 4, n_files=6)
    paths = compact_spills(ss, str(tmp_path / "out"), rows_per_file=200, block_rows=32)
    assert len(paths) == 5  # ceil(900 / 200)
    layer = ServableLayer.open(paths, block_rows=32)
    assert layer.num_rows == 900
    assert np.all(layer.file_min[1:] > layer.file_max[:-1])
    for p in paths:
        assert os.path.exists(p + ".idx")


def test_compaction_rejects_duplicates_and_empty(tmp_path):
    ss = SpillSet()
    with pytest.raises(ValueError, match="empty"):
        compact_spills(ss, str(tmp_path / "o"))
    ids = np.arange(10, dtype=np.uint64)
    rows = np.zeros((10, 2), dtype=np.float32)
    ss.add(write_spill(str(tmp_path / "a.spill"), ids, rows))
    ss.add(write_spill(str(tmp_path / "b.spill"), ids[:3], rows[:3]))
    with pytest.raises(ValueError, match="duplicate"):
        compact_spills(ss, str(tmp_path / "o"))


def test_servable_layer_rejects_overlapping_files(tmp_path):
    a = write_spill(
        str(tmp_path / "a.spill"),
        np.array([0, 5], dtype=np.uint64),
        np.zeros((2, 2), np.float32),
    )
    b = write_spill(
        str(tmp_path / "b.spill"),
        np.array([3, 9], dtype=np.uint64),
        np.zeros((2, 2), np.float32),
    )
    with pytest.raises(ValueError, match="overlapping"):
        ServableLayer.open([a.path, b.path])


def test_register_servable_layer_manifest_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    v, d = 600, 4
    csr = powerlaw_graph(v, 4, seed=1)
    store = GraphStore.create(
        str(tmp_path / "store"), csr, make_features(v, d, seed=1), num_partitions=2
    )
    ss, dense = indexed_spillset(tmp_path, rng, v, d, n_files=5)
    store.register_servable_layer(1, ss, block_rows=64, rows_per_file=256)
    assert store.servable_layers() == [1]
    # reopened store serves identical rows
    layer = ServableLayer.from_store(GraphStore.open(store.root), 1)
    eng = VertexQueryEngine(layer)
    q = rng.integers(0, v, size=100)
    got = eng.lookup(q)
    assert np.array_equal(got, np.stack([dense[int(i)] for i in q]))
    # re-registering replaces the previous files
    store.register_servable_layer(1, ss, block_rows=32, rows_per_file=128)
    entry = store.manifest["servable_layers"]["1"]
    assert entry["block_rows"] == 32
    with pytest.raises(KeyError, match="not registered"):
        ServableLayer.from_store(store, 7)
    # a failing re-registration must not destroy the registered layer
    bad = SpillSet()
    bad.add(ss.files[0])
    bad.add(ss.files[0])  # duplicate rows -> compaction raises
    with pytest.raises(ValueError, match="duplicate"):
        store.register_servable_layer(1, bad)
    layer = ServableLayer.from_store(store, 1)  # still opens and serves
    assert np.array_equal(
        VertexQueryEngine(layer).lookup(q), np.stack([dense[int(i)] for i in q])
    )


def _blk(key, n=10, dim=4):
    ids = np.arange(key * 100, key * 100 + n, dtype=np.uint64)
    return ids, np.full((n, dim), float(key), dtype=np.float32)


def test_page_cache_hit_miss_and_touch_order():
    cache = ShardedPageCache(num_keys=64, budget_bytes=1 << 20, num_shards=1)
    keys = np.array([3, 7, 11])
    assert cache.get_many(keys) == [None, None, None]
    assert cache.misses == 3
    cache.put_many(keys, [_blk(3), _blk(7), _blk(11)])
    got = cache.get_many(np.array([7, 3]))
    assert got[0] is not None and np.all(got[0][1] == 7.0)
    assert cache.hits == 2 and cache.hit_rate() == 2 / 5
    # a cache fitting two blocks (240 bytes each) evicts insertion-oldest
    small = ShardedPageCache(num_keys=64, budget_bytes=2 * 240, num_shards=1)
    small.put_many(keys, [_blk(3), _blk(7), _blk(11)])
    assert small.resident_bytes <= small.budget_bytes
    assert small.get_many(np.array([3]))[0] is None  # oldest evicted
    assert small.get_many(np.array([11]))[0] is not None  # newest kept


def test_page_cache_budget_respected_and_block_too_big_skipped():
    cache = ShardedPageCache(num_keys=32, budget_bytes=100, num_shards=2)
    cache.put_many(np.array([1]), [_blk(1, n=100)])  # way over any shard budget
    assert cache.resident_blocks == 0
    rng = np.random.default_rng(0)
    cache = ShardedPageCache(num_keys=256, budget_bytes=5000, num_shards=4)
    for _ in range(50):
        k = int(rng.integers(0, 256))
        cache.put_many(np.array([k]), [_blk(k)])
        assert cache.resident_bytes <= cache.budget_bytes
    assert cache.evicted_blocks > 0


def test_cold_point_lookup_reads_at_most_two_blocks(tmp_path):
    rng = np.random.default_rng(2)
    v = 2000
    ss, _ = indexed_spillset(tmp_path, rng, v, 4, n_files=7)
    paths = compact_spills(ss, str(tmp_path / "o"), rows_per_file=300, block_rows=32)
    eng = VertexQueryEngine(ServableLayer.open(paths, block_rows=32))
    for vid in rng.integers(0, v, size=200):
        eng.lookup(np.array([vid]))
        assert eng.last_blocks_read <= 2


def test_query_engine_missing_ids_raise(tmp_path):
    rng = np.random.default_rng(3)
    ss, dense = indexed_spillset(tmp_path, rng, 500, 4, n_files=3, sparse=True)
    paths = compact_spills(ss, str(tmp_path / "o"), rows_per_file=128, block_rows=16)
    eng = VertexQueryEngine(ServableLayer.open(paths, block_rows=16))
    present = sorted(dense)
    # beyond every file range
    with pytest.raises(KeyError, match="not present"):
        eng.lookup(np.array([max(present) + 1000]))
    # inside a block's [min, max] range but absent from its id column
    gaps = [x for x in range(present[0], present[0] + 200) if x not in dense]
    assert gaps
    with pytest.raises(KeyError, match="not present"):
        eng.lookup(np.array([gaps[0]]))
    # a good batch containing one bad id fails loudly, not silently
    with pytest.raises(KeyError):
        eng.lookup(np.array([present[0], gaps[0], present[1]]))


def test_query_engine_cache_transparency_and_warm_path(tmp_path):
    rng = np.random.default_rng(4)
    v, d = 1500, 8
    ss, dense = indexed_spillset(tmp_path, rng, v, d, n_files=6)
    paths = compact_spills(ss, str(tmp_path / "o"), rows_per_file=400, block_rows=64)
    layer = ServableLayer.open(paths, block_rows=64)
    cache = ShardedPageCache(layer.num_blocks, budget_bytes=8 << 20, num_shards=4)
    cached = VertexQueryEngine(layer, cache=cache)
    plain = VertexQueryEngine(ServableLayer.open(paths, block_rows=64))
    queries = [rng.integers(0, v, size=int(s)) for s in rng.integers(1, 200, size=30)]
    for q in queries:
        assert np.array_equal(cached.lookup(q), plain.lookup(q))
    # warm repeat touches no disk at all
    before = cached.blocks_read
    for q in queries:
        cached.lookup(q)
    assert cached.blocks_read == before
    assert cache.hits > 0


@pytest.mark.parametrize("cache_bytes", [0, 1 << 20])
def test_coalesced_gather_bit_identical_to_per_block_path(tmp_path, cache_bytes):
    """The contiguous-span fast path (one pread + one gather per run of
    adjacent missed blocks) must return exactly what the per-block oracle
    path returns, under every batch shape and cache state."""
    rng = np.random.default_rng(7)
    v, d = 4000, 6
    ss, _ = indexed_spillset(tmp_path, rng, v, d, n_files=5)
    ref = spills_to_dense(ss, v, d)
    paths = compact_spills(ss, str(tmp_path / "o"), rows_per_file=700, block_rows=32)
    engines = {}
    for co in (True, False):
        layer = ServableLayer.open(paths, block_rows=32)
        cache = (
            ShardedPageCache(layer.num_blocks, cache_bytes, num_shards=2)
            if cache_bytes
            else None
        )
        engines[co] = VertexQueryEngine(layer, cache=cache, coalesce=co)
    batches = [
        np.arange(v, dtype=np.uint64),  # full scan: maximal contiguity
        np.arange(900, 2500, dtype=np.uint64),  # range scan
        rng.integers(0, v, size=800).astype(np.uint64),  # random + dups
        np.array([17], dtype=np.uint64),  # point
        np.array([0, v - 1], dtype=np.uint64),  # span-breaking extremes
    ]
    for q in batches:
        fast, oracle = engines[True].lookup(q), engines[False].lookup(q)
        assert np.array_equal(fast, oracle)
        assert np.array_equal(fast, ref[q.astype(np.int64)])
        # warm repeat (cache hits scatter per block) stays identical
        assert np.array_equal(engines[True].lookup(q), fast)
        assert np.array_equal(engines[False].lookup(q), fast)
    # both paths fetched the same blocks; the fast path did so in fewer
    # preads and actually coalesced multi-block runs
    assert engines[True].blocks_read == engines[False].blocks_read
    assert engines[True].span_reads < engines[True].blocks_read
    assert engines[True].coalesced_blocks > 0
    assert engines[False].span_reads == 0


def test_coalesced_spans_never_cross_files_or_holes(tmp_path):
    """Span detection must break at file boundaries and at cached blocks
    sitting between two misses (non-consecutive keys)."""
    rng = np.random.default_rng(8)
    v, d = 1200, 4
    ss, _ = indexed_spillset(tmp_path, rng, v, d, n_files=4)
    ref = spills_to_dense(ss, v, d)
    # tiny files -> many file boundaries inside one big batch
    paths = compact_spills(ss, str(tmp_path / "o"), rows_per_file=150, block_rows=16)
    layer = ServableLayer.open(paths, block_rows=16)
    cache = ShardedPageCache(layer.num_blocks, 8 << 20, num_shards=2)
    eng = VertexQueryEngine(layer, cache=cache)
    # pre-warm every third block by point lookups: holes between misses
    for vid in range(0, v, 3 * 16):
        eng.lookup(np.array([vid], dtype=np.uint64))
    q = np.arange(v, dtype=np.uint64)
    assert np.array_equal(eng.lookup(q), ref)
    assert len(layer.files) > 1
    # a full re-scan is now all cache hits and still bit-identical
    before = eng.blocks_read
    assert np.array_equal(eng.lookup(q), ref)
    assert eng.blocks_read == before


def _check_bit_identical(tmp_path_factory, n, dim, n_files, block_rows, sparse):
    tmp = tmp_path_factory.mktemp("serve_prop")
    rng = np.random.default_rng(n * 131 + dim * 7 + n_files)
    ss, dense = indexed_spillset(tmp, rng, n, dim, n_files, sparse=sparse)
    paths = compact_spills(
        ss, str(tmp / "o"), rows_per_file=max(1, n // 3), block_rows=block_rows
    )
    layer = ServableLayer.open(paths, block_rows=block_rows)
    cache = ShardedPageCache(layer.num_blocks, budget_bytes=1 << 18, num_shards=2)
    eng = VertexQueryEngine(layer, cache=cache)
    if not sparse:
        ref = spills_to_dense(ss, n, dim)
    present = np.array(sorted(dense), dtype=np.int64)
    for _ in range(4):
        q = present[rng.integers(0, len(present), size=rng.integers(1, 64))]
        got = eng.lookup(q)
        expect = (
            ref[q]
            if not sparse
            else np.stack([dense[int(i)] for i in q]).astype(np.float32)
        )
        assert got.dtype == np.float32
        assert np.array_equal(got, expect)


@pytest.mark.parametrize(
    "n,dim,n_files,block_rows,sparse",
    [
        (2, 1, 1, 4, False),
        (37, 5, 3, 4, True),
        (128, 5, 6, 32, False),
        (255, 1, 4, 32, True),
        (400, 5, 2, 4, False),
        (331, 5, 5, 32, True),
    ],
)
def test_query_rows_bit_identical_to_spills_to_dense(
    tmp_path_factory, n, dim, n_files, block_rows, sparse
):
    """Acceptance property: every queried vertex row equals the
    spills_to_dense row for the same spill set, bit for bit."""
    _check_bit_identical(tmp_path_factory, n, dim, n_files, block_rows, sparse)


if HAVE_HYPOTHESIS:

    @settings(max_examples=12, deadline=None)
    @given(
        n=st.integers(2, 400),
        dim=st.sampled_from([1, 5]),
        n_files=st.integers(1, 6),
        block_rows=st.sampled_from([4, 32]),
        sparse=st.booleans(),
    )
    def test_query_rows_bit_identical_hypothesis(
        tmp_path_factory, n, dim, n_files, block_rows, sparse
    ):
        _check_bit_identical(tmp_path_factory, n, dim, n_files, block_rows, sparse)


def test_engine_output_served_end_to_end(tmp_path):
    """Full pipeline: AtlasEngine.run -> register_servable_layer -> lookups
    match the dense materialisation of the final embeddings."""
    v, d = 1200, 16
    csr = powerlaw_graph(v, 6, seed=5, self_loops=True)
    feats = make_features(v, d, seed=5)
    specs = init_gnn_params("gcn", [d, 12, 8], seed=5)
    store = GraphStore.create(str(tmp_path / "store"), csr, feats, num_partitions=2)
    cfg = AtlasConfig(chunk_bytes=64 * d * 4, hot_slots=400,
                      spill_buffer_rows=128, backend="cpu")
    with pytest.warns(DeprecationWarning):
        spills, _ = AtlasEngine(cfg).run(store, specs, str(tmp_path / "work"))
    ref = spills_to_dense(spills, v, specs[-1].out_dim)
    with pytest.warns(DeprecationWarning):
        store.register_servable_layer(
            len(specs), spills, block_rows=128, rows_per_file=500
        )
    stats = IOStats()
    layer = ServableLayer.from_store(store, len(specs), stats=stats)
    cache = ShardedPageCache(layer.num_blocks, budget_bytes=1 << 20)
    eng = VertexQueryEngine(layer, cache=cache, stats=stats)
    rng = np.random.default_rng(6)
    for _ in range(10):
        q = rng.integers(0, v, size=64)
        assert np.array_equal(eng.lookup(q), ref[q])
    assert np.array_equal(eng.lookup(np.arange(v)), ref)  # full sweep too


# --------------------------------------------------------------------------
# Entry points: the examples and the launcher
# --------------------------------------------------------------------------

ENTRY_POINTS = {  # "{tmp}" stands for a fresh temporary directory
    "distributed_gnn": ["examples/torch_distributed_gnn.py"],
    "quickstart": ["examples/torch_quickstart.py"],
    "serve_embeddings": ["examples/torch_serve_embeddings.py"],
    "infer_gnn": ["-m", "repro_torch.launch.infer_gnn", "--vertices", "3000",
                  "--dim", "16", "--hidden", "16", "--serve", "--verify"],
    "serve_lm": ["examples/torch_serve_lm.py", "--arch", "recurrentgemma-9b", "--batch", "2",
                 "--prompt-len", "16", "--tokens", "4"],
    "train_lm": ["examples/torch_train_lm.py", "--steps", "3", "--batch", "2", "--seq", "16",
                 "--ckpt", "{tmp}/ckpt"],
}


def _run_entry_point(name, tmp, *extra, hide_cards=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    args = [a.replace("{tmp}", str(tmp)) for a in ENTRY_POINTS[name]]
    return subprocess.run([sys.executable, *args, *extra],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name, tmp_path):
    out = _run_entry_point(name, tmp_path, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    if name == "infer_gnn":
        assert "served 1024 lookups from version v1" in out.stdout
        assert "mean-max-abs vs reference" in out.stdout
    else:
        assert out.stdout.rstrip().endswith("== OK")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(name, tmp_path):
    """No ``--device``: the entry point asks for the card, and on a
    machine without one it raises instead of falling back to the CPU."""
    out = _run_entry_point(name, tmp_path, hide_cards=True)
    assert out.returncode != 0
    assert "RuntimeError: CUDA device requested" in out.stderr
    assert "== OK" not in out.stdout and "[infer-gnn]" not in out.stdout


def test_train_lm_example_resumes_from_its_checkpoint(tmp_path):
    """A second run on the same ``--ckpt`` restores the first run's last
    checkpoint and trains on from its step (a later flag overrides
    ENTRY_POINTS' own)."""
    first = _run_entry_point("train_lm", tmp_path, "--steps", "1", "--ckpt-every", "1",
                             "--device", "cpu")
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stdout
    second = _run_entry_point("train_lm", tmp_path, "--steps", "2", "--device", "cpu")
    assert second.returncode == 0, second.stderr
    assert "== resumed from step 1" in second.stdout
    assert "step    2  loss" in second.stdout and second.stdout.rstrip().endswith("== OK")
