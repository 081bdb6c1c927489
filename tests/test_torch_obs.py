"""The port's span tracer (repro_torch.obs.trace) on a traced CPU run of
the out-of-core engine whose hot store evicts.

Contracts under test:

1. Every step of ``AtlasEngine._deliver`` has its own category (deliver,
   activate, policy, cold, accumulate, orchestrate, release), and each
   thread's spans stay strictly nested: ``obs_report.validate_trace`` of
   the port and of the JAX package accept the exported trace.
2. ``LayerMetrics.deliver_seconds`` times the region of the ``deliver``
   spans; the staging copies' device times are 0.0 off the card.
3. The eviction policy's victim selection and the cold store show up
   exactly when the layer reloads rows.
4. One chunk's ``read_chunk``, ``aggregate`` and ``deliver`` spans share
   its index as their ``id``, and a span without one takes its parent's.
5. An enabled tracer opens ``atlas.<category>:<name>`` profiler ranges
   on the profiler's clock; a disabled one opens none.
6. Tracing changes no output bit.
"""

import collections

import numpy as np
import pytest

from repro.launch import obs_report as r_obs
from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.graphs.synth import make_features, powerlaw_graph
from repro_torch.launch import obs_report as t_obs
from repro_torch.models.gnn import init_gnn_params
from repro_torch.obs.trace import CATEGORIES, NULL_TRACER, Tracer
from repro_torch.session import AtlasSession
from repro_torch.storage.layout import GraphStore

V, D = 1200, 16
DELIVERY_CATS = ("deliver", "activate", "policy", "cold", "accumulate", "orchestrate", "release")


def _infer(tmp, name, hot_slots, trace, store=None):
    if store is None:
        store = GraphStore.create(str(tmp / f"store_{name}"), powerlaw_graph(V, 8, seed=1),
                                  make_features(V, D, seed=2))
    specs = init_gnn_params("sage", [D, 24, 8], seed=3)
    cfg = AtlasConfig(backend="cpu", chunk_bytes=1 << 14, hot_slots=hot_slots, trace=trace)
    with AtlasSession(store, config=cfg, workdir=str(tmp / name)) as s:
        res = s.infer(specs)
        spans = s.tracer.spans()
    return store, res, spans


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A traced run whose hot store (96 slots) evicts, the same run
    untraced, and a traced run whose hot store holds every row."""
    tmp = tmp_path_factory.mktemp("obs")
    store, traced, spans = _infer(tmp, "traced", 96, True)
    _, untraced, _ = _infer(tmp, "untraced", 96, False, store)
    _, roomy, roomy_spans = _infer(tmp, "roomy", 4 * V, True, store)
    return {"traced": (traced, spans), "untraced": untraced, "roomy": (roomy, roomy_spans)}


def test_every_delivery_step_has_its_category_and_spans_nest(runs):
    res, spans = runs["traced"]
    cats = {sp["cat"] for sp in spans}
    assert set(DELIVERY_CATS) <= cats
    assert set(DELIVERY_CATS) | {"drain"} <= set(CATEGORIES)
    assert cats <= set(CATEGORIES)
    events = t_obs.load_trace(res.trace_path)
    assert t_obs.validate_trace(events) == r_obs.validate_trace(events) == []
    names = {(sp["cat"], sp["name"]) for sp in spans if sp["cat"] in DELIVERY_CATS}
    assert names >= {("policy", "select_victims"), ("policy", "add_many"),
                     ("policy", "remove_many"), ("policy", "update_many"),
                     ("cold", "cold_put"), ("cold", "cold_take")}


def test_deliver_seconds_times_the_deliver_spans(runs):
    res, spans = runs["traced"]
    deliver = sum(sp["dur_s"] for sp in spans if sp["name"] == "deliver")
    metric = sum(m.deliver_seconds for m in res.metrics)
    assert metric > 0.0
    assert metric == pytest.approx(deliver, rel=0.05, abs=2e-3)
    # the delivery steps, and release's hand-off to graduation (its
    # graduate_buffer span, filed under tail), fill the deliver spans
    steps = sum(sp["self_s"] for sp in spans if sp["cat"] in DELIVERY_CATS)
    handoff = sum(sp["dur_s"] for sp in spans
                  if sp["name"] == "graduate_buffer" and sp["thread"] == "MainThread")
    assert steps + handoff == pytest.approx(deliver, rel=1e-6, abs=1e-6)


def test_staging_copies_have_no_device_time_off_the_card(runs):
    res, _ = runs["traced"]
    for m in res.metrics:
        assert m.h2d_device_seconds == 0.0 and m.d2h_device_seconds == 0.0
        assert m.deliver_seconds < m.seconds


@pytest.mark.parametrize("run", ["traced", "roomy"])
def test_victim_selection_and_the_cold_store_appear_exactly_when_rows_reload(runs, run):
    res, spans = runs[run]
    reloads = sum(m.reloads for m in res.metrics)
    assert (reloads > 0) == (run == "traced")
    evicting = {sp["name"] for sp in spans if sp["cat"] == "cold" or sp["name"] == "select_victims"}
    assert bool(evicting) == (reloads > 0)
    # the policy's bookkeeping runs whether or not anything is evicted
    assert {"add_many", "update_many", "remove_many"} <= {
        sp["name"] for sp in spans if sp["cat"] == "policy"}


def test_one_chunks_spans_share_its_index_across_threads(runs):
    res, spans = runs["traced"]
    ids = {name: collections.Counter(sp["id"] for sp in spans if sp["name"] == name)
           for name in ("read_chunk", "prep", "aggregate", "deliver")}
    chunks = sum(m.chunks for m in res.metrics)
    assert sum(ids["read_chunk"].values()) == chunks
    assert ids["read_chunk"] == ids["prep"] == ids["aggregate"]
    # SAGE delivers every chunk's self rows: each chunk's deliver spans
    assert set(ids["deliver"]) == set(ids["read_chunk"])
    threads = {name: {sp["thread"] for sp in spans if sp["name"] == name}
               for name in ("read_chunk", "aggregate", "deliver")}
    assert threads["read_chunk"] == {"atlas-reader"}
    assert threads["aggregate"] == {"atlas-staging"}
    assert threads["deliver"] == {"MainThread"}
    # a step without an id of its own takes its deliver span's
    assert {sp["id"] for sp in spans if sp["cat"] == "activate"} <= set(ids["deliver"])
    events = t_obs.load_trace(res.trace_path)
    assert {ev["args"]["id"] for ev in events
            if ev.get("ph") == "B" and ev["name"] == "read_chunk"} == set(ids["read_chunk"])


def test_span_ids_are_exported_and_inherited():
    tr = Tracer()
    with tr.span("outer", "layer"):
        with tr.span("deliver", "deliver", id=7):
            with tr.span("activate", "activate"):
                pass
        with tr.span("other", "stall"):
            pass
    got = {sp["name"]: sp["id"] for sp in tr.spans()}
    assert got == {"outer": None, "deliver": 7, "activate": 7, "other": None}
    begins = [ev for ev in tr.events() if ev["ph"] == "B"]
    assert [ev.get("args") for ev in begins] == [None, {"id": 7}, {"id": 7}, None]
    assert not hasattr(tr, "instant") and not hasattr(NULL_TRACER, "instant")


def _atlas_ranges(tmp, trace):
    from torch.profiler import ProfilerActivity, profile, record_function

    store = GraphStore.create(str(tmp / f"pstore_{trace}"), powerlaw_graph(400, 6, seed=1),
                              make_features(400, D, seed=2))
    cfg = AtlasConfig(backend="cpu", chunk_bytes=1 << 13, hot_slots=64, trace=trace)
    specs = init_gnn_params("sage", [D, 8], seed=3)
    with AtlasSession(store, config=cfg, workdir=str(tmp / f"prof_{trace}")) as s:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caller"):
                s.infer(specs)
    events = prof.events()
    caller = [e for e in events if e.name == "caller"]
    assert len(caller) == 1
    lo, hi = caller[0].time_range.start, caller[0].time_range.end
    delivers = [e for e in events if e.name == "atlas.deliver:deliver"]
    assert all(lo <= e.time_range.start and e.time_range.end <= hi for e in delivers)
    return delivers, {e.name for e in events if e.name.startswith("atlas.")}


def test_traced_infer_puts_its_steps_on_the_profilers_clock(tmp_path):
    delivers, names = _atlas_ranges(tmp_path, True)
    assert delivers
    assert {f"atlas.{c}:{n}" for c, n in (("activate", "activate"), ("accumulate", "accumulate"),
                                          ("orchestrate", "orchestrate"), ("policy", "add_many"))
            } <= names
    delivers, names = _atlas_ranges(tmp_path, False)
    assert delivers == [] and names == set()


def test_tracing_changes_no_output_bit(runs):
    res, _ = runs["traced"]
    untraced = runs["untraced"]
    a = spills_to_dense(res.final.spills, V, res.final.dim)
    b = spills_to_dense(untraced.final.spills, V, untraced.final.dim)
    np.testing.assert_array_equal(a, b)
    assert [m.reloads for m in res.metrics] == [m.reloads for m in untraced.metrics]
    assert np.isfinite(a).all()
