"""The GAT cell (``gat-hbm``) and the hot store that fits (``sage-ooc-fit``)
on the CPU at a small size: sound runs are correct; a run with the
attention broken underneath is not (uniform attention, two heads'
columns swapped, the skip left out, the max left out of a layer whose
scores overflow without it, the projection rounded to TF32); the GAT
readers on hand-computed contexts; the control fails the limit that
float32 meets; and the new files import neither JAX nor the JAX package,
and the reference nothing of the program."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from bench import control_gat, harness
from bench.reference import gat as reference
from bench.tests.conftest import run_cell
from bench.tests.test_bench_imports import FORBIDDEN, imported_top_names

ROOT = Path(__file__).resolve().parents[2]


def _reader(name):
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("cell", ["gat-hbm", "sage-ooc-fit"])
def test_a_sound_run_is_correct(small_root, capsys, cell):
    rc, line = run_cell(small_root, cell, capsys)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1 and set(line["metrics"]) >= {"setup_s"}


def _uniform(original):
    def fault(z, a_src, a_dst):
        s, t = original(z, a_src, a_dst)
        return torch.zeros_like(s), torch.zeros_like(t)
    return fault


def _swap_heads(original):
    def fault(num, den, mx, rows, offsets, bias, *, concat, elu, scale=1.0, skip=None):
        out = original(num, den, mx, rows, offsets, bias, concat=concat, elu=elu, scale=scale,
                       skip=skip)
        if concat:
            f = out.shape[1] // den.shape[1]
            out = torch.cat([out[:, f:2 * f], out[:, :f], out[:, 2 * f:]], 1)
        return out
    return fault


def _no_skip(original):
    def fault(*args, skip=None, **kw):
        return original(*args, skip=None, **kw)
    return fault


def _no_max(original):
    """The weights ``exp(e)`` with no max subtracted: the partials the
    kernel would give, overflowing where a logit passes ~88."""
    def fault(*args, **kw):
        num, den, mx = original(*args, **kw)
        scale = torch.exp(mx)
        return num * scale.repeat_interleave(num.shape[1] // mx.shape[1], 1), den * scale, \
            torch.zeros_like(mx)
    return fault


def _tf32_projection(original):
    def fault(x, w, b, activation="relu"):
        return original(reference._round_tf32(x), reference._round_tf32(w), b, activation)
    return fault


FAULTS = {
    "uniform-attention": ("attention_scores", _uniform),
    "heads-swapped": ("attention_normalize", _swap_heads),
    "no-skip": ("attention_normalize", _no_skip),
    "tf32-projection": ("fused_graduate", _tf32_projection),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_gat_path_is_not_correct(small_root, capsys, monkeypatch, fault):
    from repro_torch.dist import mesh

    name, make = FAULTS[fault]
    monkeypatch.setattr(mesh, name, make(getattr(mesh, name)))
    rc, line = run_cell(small_root, "gat-hbm", capsys)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


def test_the_max_left_out_is_not_correct_where_the_scores_overflow(small_root, capsys,
                                                                     monkeypatch):
    """Attention vectors 10 times larger give logits past exp's f32 range:
    the program, which subtracts each destination's max, stays correct;
    without the max it is not."""
    from repro_torch.dist import mesh

    cfg = small_root / "bench" / "configs" / "gat-papers100m.json"
    c = json.loads(cfg.read_text())
    c["assumed"]["att_scale"] = [10 * a for a in c["assumed"]["att_scale"]]
    cfg.write_text(json.dumps(c))
    rc, line = run_cell(small_root, "gat-hbm", capsys)
    assert rc == 0 and line["correct"] is True
    monkeypatch.setattr(mesh, "segment_attention", _no_max(mesh.segment_attention))
    rc, line = run_cell(small_root, "gat-hbm", capsys)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


def test_gat_readers_against_hand_numbers():
    cfg = {"model": "gat", "widths": [8, 16, 4], "heads": [2, 3], "head_dims": [8, 4],
           "concat": [True, False], "skip": [True, False]}
    ctx = {"window": {"seconds": 2.0, "passes": 4},
           "graph": {"num_vertices": 1000, "num_edges": 12000}, "config": cfg,
           "trace": {"busy_s": 1.5, "window_s": 2.0, "gaps": {}, "ranges": {},
                     "device_ops": {"segment_attention_kernel<2>": 0.006,
                                    "segment_attention_scores_kernel": 0.002,
                                    "segment_attention_normalize_kernel<1>": 0.002,
                                    "sgemm_kernel": 0.5}},
           "att_s": 0.0125}
    v, e, bw, peak = 1000, 12000, 3.35e12, 67e12

    def layer(h, f, concat, skip):
        hf = h * f
        return (max(4 * (v * hf + 2 * hf + 2 * v * h) / bw, 4 * v * hf / peak)
                + max(4 * (2 * v * hf + 4 * v * h + e + v + 1) / bw, 2 * e * hf / peak)
                + max(4 * (v * hf + 2 * v * h + 2 * v + 1 + hf + (v * hf if skip else 0)
                           + v * (hf if concat else f)) / bw, 2 * v * hf / peak))

    need = layer(2, 8, True, True) + layer(3, 4, False, False)
    assert _reader("att_roofline").read(ctx) == pytest.approx(100 * 4 * need / 0.01)
    assert _reader("att_s").read(ctx) == 0.0125
    flops = (2 * v * 8 * 16 * 2 + 4 * v * 16 + 2 * e * 16) + (2 * v * 16 * 12 + 4 * v * 12
                                                               + 2 * e * 12)
    assert _reader("gat_pass_mfu").read(ctx) == pytest.approx(100 * flops / (0.5 * peak))

    def projection(k, m):  # x, W, the zero bias read and the output written once, f32
        return max(4 * (v * k + k * m + m + v * m) / bw, 2 * v * k * m / peak)

    # layer 1: [v, 8] @ [8, 2 * 16] (W | W_skip); layer 2: [v, 16] @ [16, 12]
    k2 = projection(8, 32) + projection(16, 12)
    assert _reader("gat_k2_roofline").read(ctx) == pytest.approx(100 * 4 * k2 / 0.5)
    del ctx["att_s"]
    ctx["trace"] = None
    for name in ("att_roofline", "att_s", "gat_pass_mfu", "gat_k2_roofline"):
        assert _reader(name).read(ctx) is None
    # the GCN and SAGE cells' contexts give the GAT readers nothing
    gcn = dict(ctx, config={"model": "gcn", "widths": [8, 16]},
               trace={"busy_s": 1.0, "window_s": 2.0, "gaps": {}, "ranges": {},
                      "device_ops": {"segment_rows_kernel": 0.01, "sgemm_kernel": 0.01}})
    for name in ("att_roofline", "att_s", "gat_pass_mfu", "gat_k2_roofline"):
        assert _reader(name).read(gcn) is None


def test_the_reference_softmax_by_hand():
    """Three vertices, edges 0->2, 1->2, 2->2 and the self loops 0->0,
    1->1: vertex 2's weights are a softmax of LeakyReLU(t_2 + s_u)."""
    z = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], dtype=torch.float64)
    a_src = torch.tensor([[2.0, 0.0]], dtype=torch.float64)  # s = (2, 0, 2)
    a_dst = torch.tensor([[0.0, -1.0]], dtype=torch.float64)  # t = (0, -1, -1)
    src, dst = torch.tensor([0, 1, 2, 0, 1]), torch.tensor([2, 2, 2, 0, 1])
    y = reference.attention(z, src, dst, 3, a_src, a_dst, 0.2)[:, 0]
    e = torch.tensor([1.0, -0.2, 1.0], dtype=torch.float64)  # t_2 + s_u = 1, -1, 1
    alpha = torch.softmax(e, 0)
    assert torch.allclose(y[2], alpha @ z, atol=0, rtol=1e-15)
    assert torch.equal(y[0], z[0]) and torch.equal(y[1], z[1])


def test_the_control_fails_the_limit_that_float32_meets(small_root):
    got = control_gat.readings(harness.find_cell(small_root, "gat-hbm", False), 2**31 + 17,
                               ["tf32", "f32"], "cpu")
    limit = json.loads((small_root / "bench" / "checks" / "gat-hbm.json").read_text())
    assert got["f32"] < limit["row_err"]["limit"] < got["tf32"]


@pytest.mark.parametrize("name", ["paths/hbm_gat.py", "control_gat.py", "inputs_gat.py",
                                  "reference/gat.py", "metrics/att_roofline.py",
                                  "metrics/att_s.py", "metrics/gat_pass_mfu.py",
                                  "metrics/gat_k2_roofline.py"])
def test_the_new_files_import_no_jax(name):
    names = imported_top_names(ROOT / "bench" / name)
    assert not names & FORBIDDEN
    if name.startswith("reference/"):
        assert names <= {"__future__", "contextlib", "torch", "numpy", "math"}


def test_the_fit_traffic_is_the_out_of_core_traffic_with_a_larger_store():
    fit = json.loads((ROOT / "bench" / "workloads" / "ooc-powerlaw-fit.json").read_text())
    base = json.loads((ROOT / "bench" / "workloads" / "ooc-powerlaw.json").read_text())
    assert {k: v for k, v in fit.items() if k != "hot_bytes"} == \
        {k: v for k, v in base.items() if k != "hot_bytes"}
    mib = fit["hot_bytes"] / 2**20
    assert mib == 2 ** round(math.log2(mib)) and fit["hot_bytes"] > base["hot_bytes"]


def test_the_gat_traffic_shares_the_hbm_graph():
    gat = json.loads((ROOT / "bench" / "workloads" / "hbm-powerlaw-gat.json").read_text())
    hbm = json.loads((ROOT / "bench" / "workloads" / "hbm-powerlaw.json").read_text())
    assert gat["graph"] == hbm["graph"] and gat["path"] == "hbm_gat"
