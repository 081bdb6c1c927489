"""The plain reference against outputs worked out by hand, the frozen
generators against the program's, and the control (the reference in
TF32) failing the limit that the program's float32 meets."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import control, harness, inputs
from bench.frozen import synth
from bench.reference import gnn as reference

ROOT = Path(__file__).resolve().parents[2]

# five vertices, a self loop each, and 1->0, 2->0, 3->0, 0->1, 4->2:
# in-degrees 4, 2, 2, 1, 1
SRC = [0, 1, 2, 3, 4, 1, 2, 3, 0, 4]
DST = [0, 1, 2, 3, 4, 0, 0, 0, 1, 2]
H = [[1.0, 2.0], [3.0, -1.0], [0.0, 4.0], [2.0, 2.0], [-1.0, 1.0]]


def _forward(kind, layers):
    return reference.forward(kind, torch.tensor(SRC), torch.tensor(DST), 5,
                             torch.tensor(H), [(torch.tensor(w), torch.tensor(b)) for w, b in layers])


def test_gcn_layer_by_hand():
    # out_v = sum_{u->v} (h_u[0] - h_u[1]) / sqrt(d_u d_v) + 0.5, with W = [1, -1]^T
    x = [a - b for a, b in H]  # -1, 4, -4, 0, -2
    want = [x[0] / 4 + x[1] / math.sqrt(8) + x[2] / math.sqrt(8) + x[3] / 2,
            x[1] / 2 + x[0] / math.sqrt(8),
            x[2] / 2 + x[4] / math.sqrt(2),
            x[3],
            x[4]]
    got = _forward("gcn", [([[1.0], [-1.0]], [0.5])])
    assert got.dtype == torch.float64
    assert got[:, 0].tolist() == pytest.approx([w + 0.5 for w in want], abs=1e-12)


def test_sage_layer_by_hand():
    # W = [1, 0, 0, 1]^T over [h_v ; mean]: out_v = h_v[0] + mean_v[1] - 1
    mean1 = [(2 - 1 + 4 + 2) / 4, (-1 + 2) / 2, (4 + 1) / 2, 2.0, 1.0]
    want = [h[0] + m - 1.0 for h, m in zip(H, mean1)]
    got = _forward("sage", [([[1.0], [0.0], [0.0], [1.0]], [-1.0])])
    assert got[:, 0].tolist() == pytest.approx(want, abs=1e-12)


def test_relu_between_layers_only():
    # layer 1 (gcn, W = I): relu of the sums; layer 2 sums again, no relu
    eye = [[1.0, 0.0], [0.0, 1.0]]
    got = _forward("gcn", [(eye, [0.0, -10.0]), (eye, [-100.0, 0.0])])
    d = [4, 2, 2, 1, 1]
    src, dst, h = np.array(SRC), np.array(DST), np.array(H)

    def agg(x):
        out = np.zeros_like(x)
        for u, v in zip(src, dst):
            out[v] += x[u] / math.sqrt(d[u] * d[v])
        return out

    h1 = np.maximum(agg(h) + [0.0, -10.0], 0.0)
    assert got.numpy() == pytest.approx(agg(h1) + [-100.0, 0.0], abs=1e-12)
    assert (got[:, 0] < 0).all()


def test_row_error_is_each_rows_gap_over_its_scale():
    ref = torch.tensor([[1.0, -2.0], [0.001, 0.0], [4.0, 1.0]], dtype=torch.float64)
    assert reference.row_error(ref.clone(), ref) == 0.0
    out = ref.clone()
    out[1, 0] += 0.01  # a small row is measured against the median row's scale, 2
    assert reference.row_error(out, ref) == pytest.approx(0.005)
    out = ref.clone()
    out[2, 1] = 5.0
    assert reference.row_error(out, ref) == pytest.approx(1.0)
    out[0, 0] = float("nan")
    assert reference.row_error(out, ref) == math.inf
    assert reference.row_error(ref[:2], ref) == math.inf


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    r = reference._round_tf32(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_frozen_generators_give_the_programs_graphs(seed):
    from repro_torch.graphs import synth as program

    for name in ("powerlaw", "uniform"):
        ours = synth.GENERATORS[name](500, 12, seed=seed)
        theirs = getattr(program, f"{name}_graph")(500, 12, seed=seed)
        assert np.array_equal(ours.indptr, theirs.indptr)
        assert np.array_equal(ours.indices, theirs.indices)


def test_a_cached_graph_is_the_generated_one_and_a_broken_file_is_made_anew(tmp_path):
    spec = {"generator": "powerlaw", "num_vertices": 400, "avg_degree": 12, "exponent": 1.05,
            "self_loops": True, "seed": 1}
    made, cached = inputs.make_graph(spec, tmp_path)
    assert not cached
    (f,) = (tmp_path / "graphs").iterdir()
    again, cached = inputs.make_graph(spec, tmp_path)
    assert cached
    assert np.array_equal(again.indptr, made.indptr) and np.array_equal(again.indices, made.indices)
    other, cached = inputs.make_graph({**spec, "seed": 2}, tmp_path)
    assert not cached and not np.array_equal(other.indices, made.indices)
    f.write_bytes(f.read_bytes()[:100])
    again, cached = inputs.make_graph(spec, tmp_path)
    assert not cached and np.array_equal(again.indices, made.indices)
    assert inputs.make_graph(spec)[1] is False  # no cache given


def test_inputs_repeat_for_a_seed_and_differ_between_seeds():
    cfg = json.loads((ROOT / "bench" / "configs" / "sage-papers100m.json").read_text())
    a = inputs.make_tensors(cfg, 50, 2**31 + 9, "cpu")
    b = inputs.make_tensors(cfg, 50, 2**31 + 9, "cpu")
    c = inputs.make_tensors(cfg, 50, 2**31 + 10, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert [tuple(w.shape) for w, _ in a[1]] == [(256, 256), (512, 256), (512, 172)]
    w, bias = a[1][0]
    assert float(w.abs().max()) <= math.sqrt(6 / 512) and float(bias.abs().max()) <= 0.1


def _limit(root: Path, cell: str) -> float:
    return json.loads((root / "bench" / "checks" / f"{cell}.json").read_text())["row_err"]["limit"]


@pytest.mark.parametrize("cell", ["gcn-hbm", "sage-hbm", "gcn-hbm-uniform", "sage-ooc"])
def test_the_control_fails_the_limit_that_float32_meets(small_root, cell):
    got = control.readings(harness.find_cell(small_root, cell, False), 2**31 + 17,
                           ["tf32", "f32"], "cpu")
    limit = _limit(small_root, cell)
    assert got["f32"] < limit < got["tf32"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gcn-hbm", "sage-ooc"])
def test_the_control_fails_on_the_card(small_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's own TF32 path")
    got = control.readings(harness.find_cell(small_root, cell, False), 2**31 + 17,
                           ["tf32", "f32"], "cuda")
    limit = _limit(small_root, cell)
    assert got["f32"] < limit < got["tf32"]
