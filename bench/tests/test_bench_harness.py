"""The harness: files found by name with no edit, the window's
arithmetic, the frozen roofline, the trace's reduction, the readers, and
``BENCHMARK.json`` against the contract it is written to."""

from __future__ import annotations

import json
import math
import re
import statistics
from pathlib import Path

import pytest

from bench import devtrace, harness, window
from bench.frozen import roofline
from bench.tests.conftest import run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

TOY_PATH = '''
"""A path that drives no program: it reports what its traffic says."""


def run(spec):
    passes = spec.traffic["passes"]
    trace = None
    if spec.trace:
        trace = {"busy_s": 0.5, "window_s": 2.0, "device_ops": {"toy_kernel": 0.5},
                 "gaps": {"bench.window": 1.5}, "ranges": {}}
    return {"ctx": {"setup_s": 1.5, "window": {"seconds": 2.0 * passes, "passes": passes},
                    "toy": spec.config["toy_width"], "trace": trace},
            "checks": {"toy_err.only": 0.5 * spec.traffic["err_scale"]},
            "attempted": passes,
            "device": {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}}
'''


def add_toy_cell(root: Path, err_scale: float = 1.0) -> None:
    """A new configuration, traffic, path, cell, end-to-end metric and
    per-layer metric, each its own file or entry; no file of the harness
    changes."""
    b = root / "bench"
    (b / "configs" / "toy-config.json").write_text(json.dumps({"toy_width": 7}))
    (b / "workloads" / "toy-traffic.json").write_text(
        json.dumps({"path": "toy", "passes": 4, "err_scale": err_scale}))
    (b / "paths" / "toy.py").write_text(TOY_PATH)
    (b / "checks" / "toy-cell.json").write_text(json.dumps({"toy_err": {"limit": 1.0}}))
    (b / "metrics" / "toy.width.py").write_text("def read(ctx):\n    return ctx['toy'] * 3\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-config", "source": "https://example.org/toy",
                             "file": "bench/configs/toy-config.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-config",
                               "traffic": "toy-traffic", "chips": 1, "why": "toy"})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_s":
            m["workloads"].append("toy-cell")
    bench["per_layer"].append({"name": "toy.width", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "Toy",
                               "moves": "infer_s", "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_alone_add_a_configuration_cell_path_and_metrics(small_root, capsys):
    add_toy_cell(small_root)
    rc, line = run_cell(small_root, "toy-cell", capsys)
    assert rc == 0
    assert line["metrics"] == {"infer_s": {"value": 2.0, "unit": "s"},
                               "setup_s": {"value": 1.5, "unit": "s"}}
    assert line["correct"] is True and line["attempted"] == 4
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"toy_err.only": {"value": 0.5, "limit": 1.0}}
    rc, traced = run_cell(small_root, "toy-cell", capsys, trace=1)
    assert rc == 0 and traced["metrics"] == {"toy.width": {"value": 21.0, "unit": "count"}}
    assert traced["device"]["busy_s"] == 0.5 and traced["device"]["window_s"] == 2.0
    assert traced["breakdown"] == {"device_ops": [["toy_kernel", 0.5]],
                                   "idle_gaps": [["bench.window", 1.5]]}


def test_a_number_past_its_limit_makes_the_run_incorrect(small_root, capsys):
    add_toy_cell(small_root, err_scale=3.0)
    rc, line = run_cell(small_root, "toy-cell", capsys)
    assert rc == 0 and line["correct"] is False and line["failed"] == 1


def test_judge_takes_each_numbers_limit_and_fails_what_is_not_finite():
    got = harness.judge({"row_err.first": 1e-5, "row_err.last": float("nan"),
                         "other.x": 3.0}, {"row_err": {"limit": 1e-4}, "other": {"limit": 2.0}})
    assert [got[k]["ok"] for k in ("row_err.first", "row_err.last", "other.x")] == [True, False, False]


def test_metrics_of_selects_by_workloads():
    bench = {"end_to_end": [{"name": "a", "workloads": ["c1"]}, {"name": "b", "workloads": ["c1", "c2"]}],
             "per_layer": [{"name": "p", "moves": "a", "workloads": ["c2"]},
                           {"name": "q", "moves": "b", "workloads": ["c1", "c2"]}]}
    assert set(harness.metrics_of(bench, "c1", False)) == {"a", "b"}
    assert set(harness.metrics_of(bench, "c2", False)) == {"b"}
    assert set(harness.metrics_of(bench, "c1", True)) == {"q"}
    assert set(harness.metrics_of(bench, "c2", True)) == {"p", "q"}


def test_a_metric_that_lists_no_workloads_is_in_every_cell_that_reports_what_it_moves():
    bench = {"end_to_end": [{"name": "setup_s"}, {"name": "a", "workloads": ["c1"]}],
             "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "setup_s"}]}
    for cell in ("c1", "c2", "a-cell-added-later"):
        assert "setup_s" in harness.metrics_of(bench, cell, False)
    assert set(harness.metrics_of(bench, "c1", True)) == {"p", "q"}
    assert set(harness.metrics_of(bench, "c2", True)) == {"q"}


def test_whole_passes_take_the_window_to_its_last_pass_end():
    assert window.whole_passes(10.0, [10.4, 10.9, 11.3]) == pytest.approx((1.3, 3))
    with pytest.raises(ValueError):
        window.whole_passes(0.0, [])


def test_the_rss_sampler_reads_a_positive_peak():
    s = window.RssSampler(0.001).start()
    peak = s.stop()
    assert peak > 0 and s.samples >= 2 and peak == s.stop()


def test_frozen_roofline_against_hand_numbers():
    # K1 at V=1000, E=12000, d=256: (2·1000·256·4 + 12000·8 + 1001·4) bytes, 2·12000·256 FLOPs
    cost = roofline.kernel_cost("edge_block_spmm", [((1000, 256), "float32"), ((12000,), "int32"),
                                                    ((12000,), "float32"), ((1001,), "int32"),
                                                    ((1000, 256), "float32")])
    assert cost["bytes"] == 2 * 1000 * 256 * 4 + 12000 * 8 + 1001 * 4 == 2_148_004
    assert cost["flops"] == 6_144_000 and cost["peak_flops"] == 67e12
    ms, kind = roofline.bound_ms(cost)
    assert kind == "bytes" and ms == pytest.approx(2_148_004 / 3.35e12 * 1e3)
    # K2 f32 at [8192, 512] @ [512, 256]: 2·8192·512·256 FLOPs at 67 TFLOP/s
    cost = roofline.kernel_cost("fused_graduate", [((8192, 512), "float32"), ((512, 256), "float32"),
                                                   ((256,), "float32"), ((8192, 256), "float32")])
    assert cost["flops"] == 2_147_483_648
    ms, kind = roofline.bound_ms(cost)
    assert kind == "operations" and ms == pytest.approx(2_147_483_648 / 67e12 * 1e3)
    assert roofline.H100 == {"peak_flops": 989e12, "peak_flops_f32": 67e12,
                             "hbm_bw": 3.35e12, "ici_bw": 450e9}


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_the_trace_reduces_to_busy_time_gaps_and_families():
    events = [
        _event("bench.window", "user_annotation", 1000.0, 100.0),
        _event("bench.pass", "user_annotation", 1000.0, 60.0),
        _event("bench.sync", "user_annotation", 1050.0, 10.0),
        _event("void segment_rows_kernel<float, 2>(float const*)", "kernel", 1005.0, 20.0),
        _event("void segment_rows_kernel<float, 2>(float const*)", "kernel", 1020.0, 10.0),
        _event("sgemm_kernel<float, 1, 4>(float const*)", "kernel", 1040.0, 5.0),
        _event("Memcpy DtoD", "gpu_memcpy", 1090.0, 20.0),  # clipped at the window's end
        _event("aten::empty", "cpu_op", 1000.0, 1.0),
    ]
    s = devtrace.reduce_events(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((25 + 5 + 10) * 1e-6)
    assert devtrace.family_seconds(s, ("segment_rows_kernel",)) == pytest.approx(30e-6)
    # gaps [1000, 1005), [1030, 1040), [1045, 1090), each labelled by the range open at its start
    assert s["gaps"] == {"bench.pass": pytest.approx(60e-6)}
    events.append(_event("bench.sync", "user_annotation", 1045.0, 5.0))
    assert devtrace.reduce_events(events)["gaps"] == {"bench.pass": pytest.approx(15e-6),
                                                      "bench.sync": pytest.approx(45e-6)}
    assert s["ranges"]["bench.pass"] == {"count": 1, "seconds": pytest.approx(60e-6)}
    b = devtrace.breakdown(s)
    assert b["device_ops"][0] == ["segment_rows_kernel<float, 2>", pytest.approx(30e-6)]
    assert b["idle_gaps"] == [["bench.pass", pytest.approx(60e-6)]]


def _reader(name):
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py")


def test_readers_against_hand_numbers():
    ctx = {"window": {"seconds": 2.0, "passes": 4},
           "graph": {"num_vertices": 1000, "num_edges": 12000},
           "config": {"model": "gcn", "widths": [256, 256]},
           "trace": {"busy_s": 1.5, "window_s": 2.0,
                     "device_ops": {"segment_rows_kernel": 0.01, "sgemm_kernel": 0.002},
                     "gaps": {}, "ranges": {}}}
    assert _reader("infer_s").read(ctx) == 0.5
    assert _reader("device_idle").read(ctx) == pytest.approx(25.0)
    k1 = _reader("k1_roofline").read(ctx)
    assert k1 == pytest.approx(100 * 4 * (2_148_004 / 3.35e12) / 0.01)
    k2 = _reader("k2_roofline").read(ctx)
    bytes_k2 = (1000 * 256 + 256 * 256 + 256 + 1000 * 256) * 4
    assert k2 == pytest.approx(100 * 4 * max(bytes_k2 / 3.35e12, 2 * 1000 * 256 * 256 / 67e12) / 0.002)
    flops = 2 * 12000 * 256 + 2 * 1000 * 256 * 256
    assert _reader("pass_mfu").read(ctx) == pytest.approx(100 * flops / (0.5 * 67e12))
    ctx["config"]["model"] = "sage"
    flops = 2 * 12000 * 256 + 2 * 1000 * 512 * 256
    assert _reader("pass_mfu").read(ctx) == pytest.approx(100 * flops / (0.5 * 67e12))
    ctx["trace"] = None
    for name in ("k1_roofline", "k2_roofline", "pass_mfu", "device_idle"):
        assert _reader(name).read(ctx) is None


def test_out_of_core_readers_average_over_the_same_whole_passes():
    lm = {"reloads": 10, "bytes_read": 1 << 30, "bytes_written": 1 << 29,
          "cold_bytes_read": 1 << 28, "cold_bytes_written": 1 << 28}
    ctx = {"window": {"seconds": 19.0, "passes": 2},
           "peak_host_bytes": 3 << 30,
           "ooc": {"passes": 2, "layer_metrics": [[lm, lm, lm], [lm, lm, lm]],
                   "category_seconds": {"layer": 8.5}, "pinned_peak_bytes": 1 << 29}}
    assert _reader("ooc_pass_s").read(ctx) == pytest.approx(9.5)
    assert _reader("delivery_s").read(ctx) <= _reader("ooc_pass_s").read(ctx)
    assert _reader("peak_host_gib").read(ctx) == 3.0
    assert _reader("reloads").read(ctx) == 30
    assert _reader("io_gib").read(ctx) == pytest.approx(3 * 2.0)
    assert _reader("delivery_s").read(ctx) == 8.5
    assert _reader("pinned_peak_gib").read(ctx) == 0.5
    assert _reader("delivery_s").read({"ooc": {"category_seconds": {}}}) is None


# ---------------------------------------------------------- BENCHMARK.json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per_tok", "widths")


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "bench/run.py"] and BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    runs = 2 + 14 * 24  # a full check with 24 cells
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert all(NAME.match(k) and not any(w in k for w in WIDTH_WORDS) and
                   not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for f in (f"workloads/{w['traffic']}.json", f"checks/{w['name']}.json"):
            assert (ROOT / "bench" / f).is_file()
        e2e = harness.metrics_of(BENCH, w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2 and harness.metrics_of(BENCH, w["name"], True)
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names and len(BENCH["end_to_end"]) <= 16
    # setup_s is every cell's, later cells' too, so it lists none
    assert all("workloads" not in m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e_names and "\n" not in m["layer"] and len(m["layer"]) <= 200
        for cell in m.get("workloads", []):
            assert m["moves"] in harness.metrics_of(BENCH, cell, False)


def test_every_cell_has_a_limit_set_between_its_readings():
    for w in BENCH["workloads"]:
        checks = json.loads((ROOT / "bench" / "checks" / f"{w['name']}.json").read_text())
        for name, c in checks.items():
            assert NAME.match(name) and math.isfinite(c["limit"]) and c["limit"] > 0
            if c.get("lower") is not None and c.get("upper") is not None:
                assert c["lower"] < c["limit"] < c["upper"]


def test_spread_is_taken_as_pythons_quartiles():
    # the bound rule reads quartiles as statistics.quantiles gives them
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)
