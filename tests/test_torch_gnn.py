"""Port GNN layer definitions (repro_torch.models.gnn) against the JAX
package's (repro.models.gnn), on the same numpy inputs.

``layer_update`` runs through K2's wrapper, which on CPU tensors is the
plain version.  On ``repro.exact`` fixtures (integer features and
weights, power-of-two normalisations) every sum is exact in any order,
so those comparisons are ``array_equal``; elsewhere fp32 allclose 1e-5.
"""

import numpy as np
import pytest
import torch

from repro import exact as rexact
from repro.graphs.synth import make_features, powerlaw_graph
from repro.models import gnn as rgnn
from repro_torch import exact as texact
from repro_torch.models import gnn as tgnn


def _as_dicts(specs):
    return [
        dict(kind=s.kind, in_dim=s.in_dim, out_dim=s.out_dim,
             activation=s.activation, params=s.params)
        for s in specs
    ]


def int_gin_specs(dims, seed):
    """GIN stack with small-integer MLP weights and eps=0 (``int_specs``
    gives only w/b, which gin's update cannot read)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i], dims[i + 1]
        h = max(d_in, d_out)
        specs.append(rgnn.GNNLayerSpec(
            kind="gin", in_dim=d_in, out_dim=d_out,
            activation=i < len(dims) - 2,
            params={
                "w1": rng.integers(-1, 2, size=(d_in, h)).astype(np.float32),
                "b1": rng.integers(-2, 3, size=h).astype(np.float32),
                "w2": rng.integers(-1, 2, size=(h, d_out)).astype(np.float32),
                "b2": rng.integers(-2, 3, size=d_out).astype(np.float32),
                "eps": np.float32(0.0),
            },
        ))
    return specs


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_init_gnn_params_same_numbers(kind):
    ref = rgnn.init_gnn_params(kind, [16, 24, 8], seed=5, gin_eps=0.25)
    got = tgnn.init_gnn_params(kind, [16, 24, 8], seed=5, gin_eps=0.25)
    for r, g in zip(ref, got):
        assert (r.kind, r.in_dim, r.out_dim, r.activation) == (
            g.kind, g.in_dim, g.out_dim, g.activation)
        assert (r.hot_width, r.extra_self_message) == (g.hot_width, g.extra_self_message)
        assert set(r.params) == set(g.params)
        for k in r.params:
            np.testing.assert_array_equal(np.asarray(g.params[k]), r.params[k])
        assert tgnn.self_coefficient(g) == rgnn.self_coefficient(r)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_edge_weights_identical(kind):
    rng = np.random.default_rng(1)
    in_deg = rng.integers(0, 9, 50)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    np.testing.assert_array_equal(
        tgnn.edge_weights(kind, src, dst, in_deg),
        rgnn.edge_weights(kind, src, dst, in_deg),
    )


def test_specs_from_numpy_moves_weights_to_device():
    ref = rgnn.init_gnn_params("sage", [8, 4], seed=0)
    (spec,) = tgnn.specs_from_numpy(_as_dicts(ref), device="cpu")
    assert isinstance(spec, tgnn.GNNLayerSpec)
    for k, v in spec.params.items():
        assert torch.is_tensor(v) and v.device.type == "cpu"
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[0].params[k])


def test_specs_from_numpy_refuses_cuda_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgnn.specs_from_numpy(_as_dicts(rgnn.init_gnn_params("gcn", [4, 2])))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_layer_update_exact(kind):
    csr, feats, specs = rexact.exact_graph_and_specs(256, 8, kind=kind)
    port = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    rng = np.random.default_rng(0)
    for r, p in zip(specs, port):
        rows = rng.integers(-3, 4, size=(37, r.hot_width)).astype(np.float32)
        got = tgnn.layer_update(p, torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy(), rgnn.layer_update(r, rows))


def test_layer_update_exact_gin():
    specs = int_gin_specs([8, 16, 4], seed=3)
    port = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    rng = np.random.default_rng(1)
    for r, p in zip(specs, port):
        rows = rng.integers(-3, 4, size=(29, r.hot_width)).astype(np.float32)
        got = tgnn.layer_update(p, torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy(), rgnn.layer_update(r, rows))


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_layer_update_float(kind):
    specs = rgnn.init_gnn_params(kind, [24, 40, 12], seed=2)
    port = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    rng = np.random.default_rng(2)
    for r, p in zip(specs, port):
        rows = rng.normal(size=(65, r.hot_width)).astype(np.float32)
        got = tgnn.layer_update(p, torch.from_numpy(rows))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), rgnn.layer_update(r, rows), rtol=1e-5, atol=1e-5
        )


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_dense_reference_exact(kind):
    csr, feats, specs = rexact.exact_graph_and_specs(300, 8, kind=kind, seed=4)
    port = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    got = tgnn.dense_reference(csr, feats, port, device="cpu")
    np.testing.assert_array_equal(got, rgnn.dense_reference(csr, feats, specs))


def test_dense_reference_exact_gin():
    csr = rexact.pow_degree_graph(300, (4, 16), seed=6, self_loops=True)
    feats = rexact.int_features(300, 8, seed=7)
    specs = int_gin_specs([8, 8, 4], seed=8)
    port = tgnn.specs_from_numpy(_as_dicts(specs), device="cpu")
    got = tgnn.dense_reference(csr, feats, port, device="cpu")
    np.testing.assert_array_equal(got, rgnn.dense_reference(csr, feats, specs))


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_dense_reference_float(kind):
    csr = powerlaw_graph(1024, 8, seed=3)
    feats = make_features(1024, 16, seed=4)
    specs = rgnn.init_gnn_params(kind, [16, 24, 8], seed=5)
    got = tgnn.dense_reference(csr, feats, tgnn.init_gnn_params(kind, [16, 24, 8], seed=5),
                               device="cpu")
    ref = rgnn.dense_reference(csr, feats, specs)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


def test_exact_fixtures_copied_unchanged():
    """The port's exact-arithmetic harness yields the reference's graph,
    features and weights (the tests above lean on either)."""
    rc, rf, rs = rexact.exact_graph_and_specs(128, 8, kind="sage")
    tc, tf, ts = texact.exact_graph_and_specs(128, 8, kind="sage")
    np.testing.assert_array_equal(rc.indptr, tc.indptr)
    np.testing.assert_array_equal(rc.indices, tc.indices)
    np.testing.assert_array_equal(rf, tf)
    for r, t in zip(rs, ts):
        for k in r.params:
            np.testing.assert_array_equal(r.params[k], t.params[k])
