"""The readers of the out-of-core delivery's steps and of the staging
copies over the link, on hand-built contexts: each reads what the traced
run gives, and ``None`` where a program without those spans and counters
gives nothing."""

from __future__ import annotations

from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]


def _reader(name):
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py")


def _ctx(category_seconds, layer_metrics):
    return {"window": {"seconds": 19.0, "passes": 2},
            "ooc": {"passes": 2, "layer_metrics": layer_metrics,
                    "category_seconds": category_seconds, "pinned_peak_bytes": 1 << 29}}


def test_delivery_step_readers_against_hand_numbers():
    seconds = {"layer": 1.0, "deliver": 0.5, "activate": 0.25, "policy": 2.0, "cold": 1.5,
               "accumulate": 0.75, "orchestrate": 0.125, "release": 0.375, "tail": 9.0,
               "stall": 9.0}
    lm = {"h2d_device_seconds": 0.01, "d2h_device_seconds": 0.03, "reloads": 10}
    ctx = _ctx(seconds, [[lm, lm, lm], [lm, lm, lm]])
    assert _reader("deliver_s").read(ctx) == pytest.approx(5.5)
    assert _reader("policy_s").read(ctx) == 2.0
    assert _reader("cold_s").read(ctx) == 1.5
    assert _reader("link_s").read(ctx) == pytest.approx(3 * 0.04)
    # the steps and the rest of the layer's self time make up the old delivery_s
    assert _reader("deliver_s").read(ctx) + _reader("delivery_s").read(ctx) == pytest.approx(6.5)


def test_delivery_step_readers_give_none_without_their_inputs():
    parent = _ctx({"layer": 8.5, "tail": 1.0}, [[{"reloads": 10}], [{"reloads": 10}]])
    for ctx in (parent, _ctx({}, []), {}):
        for name in ("deliver_s", "policy_s", "cold_s", "link_s"):
            assert _reader(name).read(ctx) is None, name
    assert _reader("delivery_s").read(parent) == 8.5


def test_each_reader_is_a_per_layer_metric_of_the_out_of_core_cell():
    names = {m["name"]: m for m in harness.load_json(ROOT / "BENCHMARK.json")["per_layer"]}
    for name, source in (("deliver_s", "program_span"), ("policy_s", "program_span"),
                         ("cold_s", "program_span"), ("link_s", "program_counter")):
        m = names[name]
        assert (m["unit"], m["better"], m["source"]) == ("s", "lower", source)
        assert (m["moves"], m["workloads"]) == ("peak_host_gib", ["sage-ooc"])
    assert names["policy_s"]["layer"] == names["cold_s"]["layer"] == names["reloads"]["layer"]
    assert names["deliver_s"]["layer"] == names["delivery_s"]["layer"]
    assert names["link_s"]["layer"] == names["pinned_peak_gib"]["layer"]
