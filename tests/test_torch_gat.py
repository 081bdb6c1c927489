"""GAT (``kind="gat"``) on the port's device mesh, on the CPU: the layer
steps against the plain reference ``models/gat_ref.py``, the attention's
plain versions by hand, and the paths that refuse it.

The steps run in f32 through the kernels' plain versions; the reference
in f64.  Tolerance: 1e-5 of the largest output magnitude, for f32
products and sums (of up to ~5,000 terms at the hub, the softmax's
exponentials among them) against f64 ones; the steps read 1e-7 to 1e-6.
The graph is power-law with a hub past the kernel's slab of 2,048 edges.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.atlas import AtlasConfig, AtlasEngine
from repro_torch.dist import mesh as tmesh
from repro_torch.graphs.csr import build_csr
from repro_torch.graphs.synth import powerlaw_graph
from repro_torch.kernels import segment_attention as sa
from repro_torch.kernels.ref import edge_block_spmm_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import gat_ref
from repro_torch.models.gnn import (
    dense_reference,
    edge_weights,
    init_gnn_params,
    layer_update,
    require_static_weights,
)
from repro_torch.obs.trace import Tracer

TOL = 1e-5  # of the largest output magnitude: f32 against f64 (module docstring)
V = 3000
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
DIMS = [16, 64, 32, 12]  # heads 4 of 16, 4 of 8, 6 of 12 averaged
HEADS = [4, 4, 6]


@pytest.fixture(scope="module")
def case():
    csr = powerlaw_graph(V, 12, seed=5)
    specs = init_gnn_params("gat", DIMS, seed=1, heads=HEADS, skip=[False, True, False],
                            att_scale=[6.0, 6.0, 6.0])
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((V, DIMS[0])).astype(np.float32)
    specs = [dataclasses.replace(s, params=dict(
        s.params, b=rng.uniform(-0.1, 0.1, s.params["b"].shape).astype(np.float32)))
        for s in specs]
    return csr, specs, feats


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices="cpu")


def _err(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def test_the_graph_has_a_hub_past_the_slab(case):
    csr = case[0]
    assert np.bincount(csr.indices, minlength=V).max() > sa.SLAB_EDGES


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_run_layers_matches_the_reference(case, shape):
    """Three layers (a skip across the second, the mean over six heads last)
    through ``run_layers`` on every mesh: every padded row within TOL."""
    csr, specs, feats = case
    mesh = _mesh(shape)
    plan = tmesh.build_combined_plan(csr, mesh.num_shards, "gat")
    x = tmesh.pad_features(feats, plan)
    got, moved = tmesh.run_layers(mesh, plan, torch.from_numpy(x), specs)
    want = gat_ref.forward(tmesh.pad_graph(csr, plan), x, specs, torch.float64)
    assert got.shape == want.shape == (mesh.num_shards * plan.v_local, DIMS[-1])
    assert _err(got, want) < TOL
    assert len(moved) == 3 and (moved[0].all_to_all > 0) == (mesh.num_shards > 1)
    assert (moved[1].reduce_scatter > 0) == (mesh.model_size > 1)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_combined_step_is_one_layer_of_the_reference(case, shape):
    """The skip layer alone through ``make_combined_layer_step(kind="gat")``,
    its output shards gathered: within TOL of the reference's layer."""
    csr, specs, feats = case
    mesh = _mesh(shape)
    plan = tmesh.build_combined_plan(csr, mesh.num_shards, "gat")
    rng = np.random.default_rng(3)
    x = tmesh.pad_features(rng.standard_normal((V, DIMS[1])).astype(np.float32), plan)
    spec = specs[1]
    step = tmesh.make_combined_layer_step(mesh, kind="gat", concat=True, activation=True)
    out = step(tmesh.shard_features(mesh, x), plan, *tmesh.layer_weights(spec, torch.float32))
    assert [[tuple(t.shape) for t in row] for row in out] == \
        [[(plan.v_local, DIMS[2] // mesh.model_size)] * mesh.model_size] * mesh.num_shards
    g = tmesh.pad_graph(csr, plan)
    src, dst = (torch.from_numpy(a.astype(np.int64)) for a in g.edges_for_range(0, g.num_vertices))
    want = gat_ref.layer(torch.from_numpy(x).double(), src, dst, g.num_vertices, spec)
    assert _err(tmesh.gather_shards(out), want) < TOL


def test_zero_attention_vectors_give_the_sage_mean_of_the_projections(case):
    """With ``a_src = a_dst = 0`` every logit is 0, so α = 1 / in-degree and
    each head is the mean of its projected in-neighbours: SAGE's mean
    aggregation (its ``1/deg`` edge weights) of ``x W``."""
    csr, specs, feats = case
    spec = specs[0]
    p = dict(spec.params, a_src=np.zeros_like(spec.params["a_src"]),
             a_dst=np.zeros_like(spec.params["a_dst"]), b=np.zeros_like(spec.params["b"]))
    spec = dataclasses.replace(spec, params=p, activation=False)
    mesh = _mesh((2, 2))
    plan = tmesh.build_combined_plan(csr, 2, "gat")
    x = tmesh.pad_features(feats, plan)
    step = tmesh.make_combined_layer_step(mesh, kind="gat", concat=True, activation=False)
    got = tmesh.gather_shards(step(tmesh.shard_features(mesh, x), plan,
                                   *tmesh.layer_weights(spec, torch.float32)))
    g = tmesh.pad_graph(csr, plan)
    src, dst = g.edges_for_range(0, g.num_vertices)
    in_deg = np.bincount(dst, minlength=g.num_vertices)
    w = torch.from_numpy(edge_weights("sage", src, dst, in_deg)).double()
    z = torch.from_numpy(x).double() @ torch.from_numpy(spec.params["w"]).double()
    want = edge_block_spmm_ref(z, torch.from_numpy(src), torch.from_numpy(dst), w,
                               g.num_vertices).double()
    assert _err(got, want) < TOL


def test_three_vertices_against_hand_computed_attention():
    """Edges 0->2, 1->2 and a self loop at each vertex; one head of width 2,
    ``W = I``, ``s = x·(2, −1) = (2, −1, 1)``, ``t = x·(−0.5, 0)``: vertex
    2's logits are LeakyReLU(t_2 + s_u) = (1.5, −0.3, 0.5), α their softmax,
    and y_2 = Σ α_u x_u; vertices 0 and 1 see only themselves.  The output layer (mean over one head) adds the bias."""
    x = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], np.float32)
    csr = build_csr(np.array([0, 1, 0, 1, 2]), np.array([2, 2, 0, 1, 2]), 3)
    params = {"w": np.eye(2, dtype=np.float32), "a_src": np.array([[2.0, -1.0]], np.float32),
              "a_dst": np.array([[-0.5, 0.0]], np.float32), "b": np.array([0.25, -0.5], np.float32)}
    spec = init_gnn_params("gat", [2, 2], heads=[1])[0]
    spec = dataclasses.replace(spec, params=params)
    e = np.array([1.5, -0.3, 0.5])  # LeakyReLU(t_2 + s_u) for u = 0, 1, 2
    alpha = np.exp(e - e.max()) / np.exp(e - e.max()).sum()
    want = np.stack([x[0], x[1], alpha @ x]) + params["b"]
    mesh = _mesh((1, 1))
    plan = tmesh.build_combined_plan(csr, 1, "gat")
    got, _ = tmesh.run_layers(mesh, plan, torch.from_numpy(x), [spec])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gat_ref.forward(csr, x, [spec]).numpy(), want, rtol=1e-12,
                               atol=1e-12)


def test_a_model_size_that_does_not_divide_the_heads_raises(case):
    csr, specs, feats = case
    mesh = _mesh((1, 4))
    plan = tmesh.build_combined_plan(csr, 1, "gat")
    x = torch.from_numpy(tmesh.pad_features(feats, plan))
    with pytest.raises(ValueError, match=r"heads \[4, 4, 6\]"):
        tmesh.run_layers(mesh, plan, x, specs)
    step = tmesh.make_combined_layer_step(mesh, kind="gat", concat=False, activation=False)
    with pytest.raises(ValueError, match="6 heads do not divide by 4"):
        step(tmesh.shard_features(mesh, torch.zeros(plan.v_local, 32)), plan,
             *tmesh.layer_weights(specs[2], torch.float32))


def test_the_gat_step_refuses_what_it_cannot_run(case):
    csr, specs, feats = case
    mesh = _mesh((2, 1))
    x = tmesh.shard_features(mesh, torch.zeros(2 * (V // 2), DIMS[0]))
    with pytest.raises(TypeError, match="CombinedEdgePlan"):
        tmesh.make_combined_layer_step(mesh, kind="gat")(
            x, tmesh.build_edge_plan(csr, 2, "gat"), *tmesh.layer_weights(specs[0], torch.float32))
    with pytest.raises(ValueError, match="no self term"):
        tmesh.make_combined_layer_step(mesh, kind="gat", has_self=True)
    with pytest.raises(ValueError, match="no activation"):
        tmesh.make_combined_layer_step(mesh, kind="gat", concat=False, activation=True)


def test_gcn_and_sage_steps_keep_their_class(case):
    mesh = _mesh((1, 1))
    assert type(tmesh.make_combined_layer_step(mesh)) is tmesh.LayerStep
    assert type(tmesh.make_combined_layer_step(mesh, has_self=True)) is tmesh.LayerStep
    assert type(tmesh.make_combined_layer_step(mesh, kind="gat")) is tmesh.GATLayerStep


@pytest.mark.parametrize("has_self", [False, True], ids=["gcn", "sage"])
def test_gcn_and_sage_steps_refuse_a_tracer(has_self):
    with pytest.raises(ValueError, match="only kind='gat' takes a tracer"):
        tmesh.make_combined_layer_step(_mesh((1, 1)), has_self=has_self, tracer=Tracer())


def test_an_enabled_tracer_spans_each_phase_and_the_null_tracer_records_nothing(case):
    csr, specs, feats = case
    mesh = _mesh((2, 2))
    plan = tmesh.build_combined_plan(csr, 2, "gat")
    x = tmesh.shard_features(mesh, tmesh.pad_features(feats, plan))
    args = tmesh.layer_weights(specs[0], torch.float32)
    tracer = Tracer()
    traced = tmesh.make_combined_layer_step(mesh, kind="gat", tracer=tracer)(x, plan, *args)
    plain = tmesh.make_combined_layer_step(mesh, kind="gat")
    for a, b in zip(traced, plain(x, plan, *args)):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    names = [(s["cat"], s["name"]) for s in tracer.spans()]
    assert names == [("gat", n) for n in ("project", "score", "aggregate", "exchange",
                                          "normalize")]
    assert plain.tracer.num_spans == 0 and plain.attention_seconds() == 0.0  # no events off the card


def test_the_out_of_core_engine_refuses_gat(case):
    spec = case[1][0]
    with pytest.raises(ValueError, match="device mesh"):
        require_static_weights(spec)
    with pytest.raises(ValueError, match="device mesh"):
        AtlasEngine(AtlasConfig(backend="cpu")).run_layer(None, None, None, spec, "")
    require_static_weights(init_gnn_params("sage", [4, 4])[0])  # the other kinds pass


def test_init_layer_update_and_dense_reference_for_gat(case):
    csr, specs, feats = case
    assert [(s.in_dim, s.out_dim, s.heads, s.concat, s.activation) for s in specs] == [
        (16, 64, 4, True, True), (64, 32, 4, True, True), (32, 12, 6, False, False)]
    assert [tuple(s.params["a_src"].shape) for s in specs] == [(4, 16), (4, 8), (6, 12)]
    assert "w_skip" in specs[1].params and "w_skip" not in specs[0].params
    with pytest.raises(ValueError, match="divide by its 3 heads"):
        init_gnn_params("gat", [8, 16, 4], heads=[3, 2])
    spec = specs[1].to("cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32))
    proj = layer_update(spec, x)
    torch.testing.assert_close(proj, x @ torch.cat([spec.params["w"], spec.params["w_skip"]], 1))
    assert np.array_equal(edge_weights("gat", np.arange(3), np.arange(3), np.ones(3)),
                          np.ones(3, np.float32))
    want = gat_ref.forward(csr, feats, specs, torch.float32).numpy()
    np.testing.assert_array_equal(dense_reference(csr, feats, specs, device="cpu"), want)


def test_the_slab_table():
    """Segments of 0, 1, L, L + 1 and 2L + 1 edges: one slab each up to L
    (an empty segment one empty slab), then slabs of L from the segment's
    first edge, their partial rows in order, and one combine record per
    segment cut."""
    L = sa.SLAB_EDGES
    lengths = [0, 1, L, L + 1, 2 * L + 1]
    offsets = torch.tensor(np.r_[0, np.cumsum(lengths)], dtype=torch.int32)
    slabs = sa.attention_slabs(offsets)
    o = offsets.tolist()
    want = [[0, 0, 0, -1], [1, 0, 1, -1], [2, 1, 1 + L, -1],
            [3, o[3], o[3] + L, 0], [3, o[3] + L, o[4], 1],
            [4, o[4], o[4] + L, 2], [4, o[4] + L, o[4] + 2 * L, 3], [4, o[4] + 2 * L, o[5], 4]]
    assert slabs.table.tolist() == want
    assert slabs.multis.tolist() == [[3, 0, 2, 0], [4, 2, 3, 0]] and slabs.partials == 5


def test_the_plain_attention_by_segments():
    """Two heads of width 2 over segments of 2, 0 and 1 edges (one source
    out of range): the partials a plain softmax gives, then normalised
    from two partial rows of one destination."""
    z = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]], dtype=torch.float64)
    s = torch.tensor([[1.0, 0.0], [2.0, -1.0]], dtype=torch.float64)
    t_seg = torch.tensor([[0.0, 0.0], [1.0, 1.0], [-4.0, 1.0]], dtype=torch.float64)
    src = torch.tensor([0, 1, 1, 7], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    num, den, mx = sa.segment_attention(z, s, t_seg, src, offsets)
    e0 = torch.tensor([[1.0, 0.0], [2.0, -0.2]], dtype=torch.float64)  # segment 0's logits
    m0 = e0.max(0).values
    w0 = torch.exp(e0 - m0)
    torch.testing.assert_close(mx[0], m0)
    torch.testing.assert_close(den[0], w0.sum(0))
    torch.testing.assert_close(num[0], (w0[:, :, None] * z.view(2, 2, 2)).sum(0).view(4))
    assert den[1].tolist() == [0.0, 0.0] and mx[1].tolist() == [sa.ATT_EMPTY] * 2
    e2 = torch.tensor([-0.4, 0.0], dtype=torch.float64)  # LeakyReLU(-4 + 2), LeakyReLU(1 - 1)
    torch.testing.assert_close(mx[2], e2)
    # segments 0 and 2 are one destination's two partial rows (two source shards)
    y = sa.attention_normalize(num, den, mx, torch.tensor([0, 2], dtype=torch.int32),
                               torch.tensor([0, 2], dtype=torch.int32),
                               torch.zeros(4, dtype=torch.float64), concat=True, elu=False)
    e = torch.cat([e0, e2[None]])
    a = torch.softmax(e, 0)
    rows = torch.stack([z[0], z[1], z[1]]).view(3, 2, 2)
    torch.testing.assert_close(y[0], (a[:, :, None] * rows).sum(0).view(4))
