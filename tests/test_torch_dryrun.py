"""The port's planner (``repro_torch.launch.dryrun``, ``repro_torch.perf.hlo_cost``)
against the reference's dry-run and cost model, on the CPU.

The reference compiles each cell with XLA; the port counts its own program
on the ``meta`` device.  Oracles:

- ``shape_applicable``, the parameter counts, ``input_specs`` and the
  abstract caches: equal to the reference's, field by field;
- the argument and output bytes of the two cells the reference compiles on
  this JAX (mamba2-2.7b ``long_500k`` and deepseek-moe-16b ``decode_32k``,
  smoke configs, on ``1,1`` and ``2,4``), read from XLA's
  ``memory_analysis`` in a subprocess of the reference's launcher with
  ``--devices N``: equal, given two conventions of the compiled step that
  the port's eager one has not (``_XLA_LENGTH``, ``_XLA_TUPLE``);
- FLOPs: the reference's ``repro.perf.hlo_cost.analyze`` (jax-free) on a
  jitted ``lax.scan`` of matmul layers, exactly, and on the two decode
  cells' ``.hlo.gz`` at ``1,1``, within 1 %;
- ``roofline_terms``: the reference's, on the same hardware dict;
- ``kernel_cost``: ``PERF.md``'s bound column, to its printed digits;
- the one-device qwen2-7b smoke step: a count written out by hand;
- ``ShardedTrainStep(plan=True)`` (one shard and one position per
  signature, weighted) against the step over every position.

The reference's launcher never runs in this process: it rewrites
``XLA_FLAGS`` at import.  The three reference cells that fail on this JAX
(``tests/test_dryrun_smoke.py``: ``with_sharding_constraint`` on Explicit
mesh axes) have counterparts here that must pass.
"""

import dataclasses
import gzip
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (
    SHAPES as R_SHAPES,
    get_config as r_get_config,
    get_smoke_config as r_get_smoke_config,
    input_specs as r_input_specs,
    list_archs as r_list_archs,
    shape_applicable as r_shape_applicable,
)
from repro.perf import hlo_cost as r_hlo_cost
from repro.train import step as r_step
from repro_torch.configs.registry import (
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    input_specs,
    list_archs,
    shape_applicable,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.perf import hlo_cost
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train import step as port_step
from repro_torch.train.step import abstract_cache, abstract_params

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The reference's cache carries its length as an int32 array, an argument and
# an output of the compiled step; the port's is a Python int.
_XLA_LENGTH = 4
# XLA's output buffer of a compiled step that returns a tuple holds the
# tuple's table of leaf pointers, 8 bytes a leaf (logits and the cache's
# leaves, its length among them).
_XLA_POINTER = 8

XLA_CELLS = [("mamba2-2.7b", "long_500k"), ("deepseek-moe-16b", "decode_32k")]
XLA_MESHES = [("1,1", 1), ("2,4", 8)]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    """The reference's launcher on the two cells it compiles, on ``1,1``
    (with its ``.hlo.gz``) and ``2,4``: ``{(arch, shape, mesh): record}``."""
    out = tmp_path_factory.mktemp("reference_dryrun")
    recs = {}
    for mesh, n in XLA_MESHES:
        for arch, shape in XLA_CELLS:
            cmd = [sys.executable, "-m", "repro.launch.dryrun", "--devices", str(n), "--smoke",
                   "--arch", arch, "--shape", shape, "--mesh-shape", mesh, "--out", str(out)]
            if mesh != "1,1":
                cmd.append("--no-hlo")
            r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), cwd=ROOT,
                               timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            tag = mesh.replace(",", "x")
            recs[arch, shape, mesh] = json.loads((out / f"{arch}__{shape}__{tag}.json").read_text())
    return recs


def _port_cell(arch, shape, mesh, tmp_path):
    dims = tuple(int(x) for x in mesh.split(","))
    m = make_mesh(dims, ("data", "model"), "meta")
    return dryrun.run_cell(arch, shape, m, mesh.replace(",", "x"), str(tmp_path), smoke=True,
                           save_ops=False)


# ---------------------------------------------------------------- registry


def test_shape_applicable_matches_the_reference_for_every_cell():
    assert list_archs() == r_list_archs()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    for arch in list_archs():
        for get, r_get in ((get_config, r_get_config), (get_smoke_config, r_get_smoke_config)):
            for name in SHAPES:
                assert shape_applicable(get(arch), SHAPES[name]) == r_shape_applicable(
                    r_get(arch), R_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", r_list_archs())
def test_params_and_moment_dtype_match_the_reference_at_published_configs(arch):
    leaves = jax.tree.leaves(r_step.abstract_params(r_get_config(arch)))
    want = sum(math.prod(v.shape) for v in leaves)
    params = abstract_params(get_config(arch))
    assert dryrun._param_count(params) == want
    assert all(t.device.type == "meta" for t in jax.tree.leaves(params))
    moments = "bfloat16" if want > dryrun.BIG_MODEL_PARAMS else "float32"
    assert dryrun._opt_cfg_for(params).moment_dtype == moments
    assert (moments == "bfloat16") == (arch == "arctic-480b")


def _spec(t):
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def _r_spec(t):
    return tuple(t.shape), str(jnp.dtype(t.dtype))


@pytest.mark.parametrize("arch", r_list_archs())
def test_input_specs_and_abstract_cache_match_the_reference(arch):
    cfg, r_cfg = get_smoke_config(arch), r_get_smoke_config(arch)
    for name in SHAPES:
        got = input_specs(cfg, SHAPES[name])
        want = r_input_specs(r_cfg, R_SHAPES[name])
        assert list(got) == list(want), (arch, name)
        assert {k: _spec(v) for k, v in got.items()} == {k: _r_spec(v) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    for batch, max_len in ((2, 24), (3, 7)):
        got = abstract_cache(cfg, batch, max_len)
        want = r_step.abstract_cache(r_cfg, batch, max_len)
        assert got.pop("length") == 0 and _r_spec(want.pop("length")) == ((), "int32")
        g = {k: _spec(v) for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
        w = {k: _r_spec(v) for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert g == w, arch


# ------------------------------------------------- memory against XLA's


@pytest.mark.parametrize("arch,shape", XLA_CELLS)
@pytest.mark.parametrize("mesh", [m for m, _ in XLA_MESHES])
def test_argument_and_output_bytes_equal_xla(reference_cells, tmp_path, arch, shape, mesh):
    """Per device, from the placements: the parameters, the cache and the
    batch in; the logits and the cache out.  XLA's counts add the int32
    length (in and out) and the output tuple's pointer table."""
    want = reference_cells[arch, shape, mesh]["memory_analysis"]
    got = _port_cell(arch, shape, mesh, tmp_path)
    assert got["status"] == "ok"
    leaves = 1 + len(jax.tree.leaves(abstract_cache(get_smoke_config(arch), 1, 2)))  # + logits
    assert got["memory_analysis"]["argument_bytes"] + _XLA_LENGTH == want["argument_bytes"]
    assert (got["memory_analysis"]["output_bytes"] + _XLA_LENGTH + _XLA_POINTER * leaves
            == want["output_bytes"])


# ------------------------------------------------------------- FLOPs


def test_scan_of_matmuls_counts_the_reference_flops_exactly():
    """A jitted ``lax.scan`` over L matmul layers: the reference's parser
    multiplies the loop body by its trip count; the port's eager loop runs
    L matmuls.  Equal FLOPs."""
    L, b, d = 6, 8, 32

    def scan(h, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), h, ws)[0]

    text = jax.jit(scan).lower(jax.ShapeDtypeStruct((b, d), jnp.float32),
                               jax.ShapeDtypeStruct((L, d, d), jnp.float32)).compile().as_text()
    want = r_hlo_cost.analyze(text)["flops"]

    def loop(h, ws):
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    h = torch.empty((b, d), device="meta")
    ws = torch.empty((L, d, d), device="meta")
    got = hlo_cost.analyze(hlo_cost.trace_ops(loop, h, ws)[1])
    assert got["flops"] == want == 2 * L * b * d * d
    assert got["transcendentals"] == L * b * d


@pytest.mark.parametrize("arch,shape", XLA_CELLS)
def test_decode_cells_flops_within_one_percent_of_the_reference(reference_cells, tmp_path,
                                                                  arch, shape):
    """The reference's ``analyze`` of the written ``.hlo.gz`` at ``1,1``.
    By op class: the matmuls and the attention's two einsums over the full
    cache agree term for term; the gap is XLA's fused dots against the
    port's bmm for the MoE router and experts, under 0.01 % here."""
    path = reference_cells[arch, shape, "1,1"]["hlo"]
    with gzip.open(path, "rt") as fh:
        want = r_hlo_cost.analyze(fh.read())["flops"]
    got = _port_cell(arch, shape, "1,1", tmp_path)["cost_analysis"]["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_roofline_terms_match_the_reference():
    analysis = {"flops": 3.1e15, "bytes": 2.2e12, "collective_bytes": 5.5e10}
    for hw in (hlo_cost.H100, r_hlo_cost.V5E):
        assert hlo_cost.roofline_terms(analysis, hw) == r_hlo_cost.roofline_terms(analysis, hw)
    assert hlo_cost.H100 == {"peak_flops": 989e12, "peak_flops_f32": 67e12, "hbm_bw": 3.35e12,
                             "ici_bw": 450e9}


# (name, tensors in then out, attrs, PERF.md's bound ms, bound_by)
BF, F32 = "bfloat16", "float32"
BOUND_CASES = [
    ("fused_graduate", [((8192, 512), F32), ((512, 256), F32), ((256,), F32),
                        ((8192, 256), F32)], {"activation": "relu"}, 0.0321, "operations"),
    ("fused_graduate", [((8192, 512), BF), ((512, 256), BF), ((256,), BF), ((8192, 256), BF)],
     {"activation": "relu"}, 0.0038, "bytes"),
    ("flash_attention", [((1, 16, 4096, 256), BF), ((1, 1, 4096, 256), BF),
                         ((1, 1, 4096, 256), BF), ((1, 16, 4096, 256), BF)],
     {"causal": True, "window": 2048}, 0.1042, "operations"),
    ("flash_attention_bwd", [((1, 16, 4096, 256), BF), ((1, 1, 4096, 256), BF),
                             ((1, 1, 4096, 256), BF), ((1, 16, 4096, 256), BF),
                             ((1, 16, 4096, 256), BF), ((16, 4096), F32),
                             ((1, 16, 4096, 256), BF), ((1, 1, 4096, 256), BF),
                             ((1, 1, 4096, 256), BF)], {"causal": True, "window": 2048},
     0.2606, "operations"),
    ("flash_attention_bwd", [((1, 16, 4096, 256), F32), ((1, 1, 4096, 256), F32),
                             ((1, 1, 4096, 256), F32), ((1, 16, 4096, 256), F32),
                             ((1, 16, 4096, 256), F32), ((16, 4096), F32),
                             ((1, 16, 4096, 256), F32), ((1, 1, 4096, 256), F32),
                             ((1, 1, 4096, 256), F32)], {"causal": True, "window": 2048},
     3.8469, "operations"),
    ("flash_attention_bwd", [((2, 40, 2048, 128), BF), ((2, 8, 2048, 128), BF),
                             ((2, 8, 2048, 128), BF), ((2, 40, 2048, 128), BF),
                             ((2, 40, 2048, 128), BF), ((80, 2048), F32),
                             ((2, 40, 2048, 128), BF), ((2, 8, 2048, 128), BF),
                             ((2, 8, 2048, 128), BF)], {"causal": True}, 0.2172, "operations"),
    ("ssd_scan_bwd", [((160, 2048, 64), BF), ((160, 2048), F32), ((2, 2048, 128), BF),
                      ((2, 2048, 128), BF), ((160, 2048, 64), BF), ((160, 2048, 64), BF),
                      ((160, 2048), F32), ((2, 2048, 128), BF), ((2, 2048, 128), BF)],
     {"chunk": 256, "heads_per_bc": 80}, 0.0707, "operations"),
    ("ssd_scan_bwd", [((160, 2048, 64), F32), ((160, 2048), F32), ((2, 2048, 128), F32),
                      ((2, 2048, 128), F32), ((160, 2048, 64), F32), ((160, 2048, 64), F32),
                      ((160, 2048), F32), ((2, 2048, 128), F32), ((2, 2048, 128), F32)],
     {"chunk": 256, "heads_per_bc": 80}, 1.0442, "operations"),
    ("rms_norm", [((500, 5120), BF), ((5120,), BF), ((500, 5120), BF)], {}, 0.0031, "bytes"),
    ("rms_norm", [((4096, 4096), BF), ((4096,), BF), ((4096, 4096), BF)], {}, 0.0200, "bytes"),
    ("rms_norm", [((4096, 3584), BF), ((3584,), BF), ((4096, 3584), BF)], {}, 0.0175, "bytes"),
    ("rms_norm", [((1024, 3584), BF), ((3584,), BF), ((1024, 3584), BF)], {}, 0.0044, "bytes"),
    ("rms_norm_bwd", [((4096, 5120), BF), ((5120,), BF), ((4096, 5120), BF),
                      ((4096, 5120), BF), ((5120,), BF)], {}, 0.0376, "bytes"),
    ("rms_norm_bwd", [((4096, 2048), BF), ((2048,), BF), ((4096, 2048), BF),
                      ((4096, 2048), BF), ((2048,), BF)], {}, 0.0150, "bytes"),
    ("rms_norm_bwd", [((4096, 3584), BF), ((3584,), BF), ((4096, 3584), BF),
                      ((4096, 3584), BF), ((3584,), BF)], {}, 0.0263, "bytes"),
    ("rglru_scan", [((1, 4096, 4096), F32), ((1, 4096, 4096), F32), ((1, 4096, 4096), F32)],
     {"chunk": 128}, 0.0601, "bytes"),
    ("rglru_scan", [((4, 128, 4096), F32), ((4, 128, 4096), F32), ((4, 128, 4096), F32)],
     {"chunk": 128}, 0.0075, "bytes"),
    ("rglru_scan_bwd", [((1, 4096, 4096), F32)] * 5, {"chunk": 128}, 0.1002, "bytes"),
    ("rglru_scan_bwd", [((4, 128, 4096), F32)] * 5, {"chunk": 128}, 0.0125, "bytes"),
]


@pytest.mark.parametrize("name,tensors,attrs,want,by", BOUND_CASES)
def test_kernel_cost_gives_the_bound_column(name, tensors, attrs, want, by):
    ms, bound_by = hlo_cost.bound_ms(hlo_cost.kernel_cost(name, tensors, **attrs))
    assert (round(ms, 4), bound_by) == (want, by)


# ------------------------------------------------------ the train step


def _batch(cfg, b, s):
    return input_specs(cfg, ShapeSpec("t", s, b, "train"))


def test_qwen2_smoke_step_counts_what_is_written_out_by_hand():
    """One step of qwen2-7b's smoke config (f32, 2 layers, remat) on
    ``meta``: the projections and ``lm_head`` (2·tokens·in·out each) once
    forward and twice backward; the blocks' again under remat, up to the
    last tensor the backward needs (non-reentrant checkpointing stops the
    recompute there: each block's ``down`` projection is not run again);
    K3 by ``kernel_cost``, forward twice and backward once.  K5's
    operations and the elementwise work stay out of the FLOPs."""
    cfg = get_smoke_config("qwen2-7b")
    b, s = 2, 8
    t = b * s
    d, q, kv, ff, v = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.vocab_size
    layer = 2 * t * (d * q + 2 * d * kv + q * d + 2 * d * ff + ff * d)
    head = 2 * t * d * v
    shapes = [((b, cfg.num_heads, s, cfg.head_dim), F32),
              ((b, cfg.num_kv_heads, s, cfg.head_dim), F32)] * 2
    fwd = hlo_cost.kernel_cost("flash_attention", shapes, causal=True)["flops"]
    bwd = hlo_cost.kernel_cost("flash_attention_bwd", shapes + shapes[:1], causal=True)["flops"]
    down = 2 * t * ff * d
    want = cfg.num_layers * (4 * layer - down + 2 * fwd + bwd) + 3 * head
    got = hlo_cost.analyze(dryrun.count_train_step(cfg, AdamWConfig(), _batch(cfg, b, s)))
    assert got["flops"] == want
    assert got["kernels"] == {"rms_norm": 2 * 2 * 2 + 1, "flash_attention": 4,
                              "rms_norm_bwd": 2 * 2 + 1, "flash_attention_bwd": 2}
    assert got["collective_bytes"] == 0
    assert got["argument_bytes"] > 0 and got["peak_bytes"] > got["argument_bytes"]


@pytest.mark.parametrize("arch", r_list_archs())
def test_every_smoke_step_counts_the_same_twice(arch):
    cfg = get_smoke_config(arch)
    opt = dryrun._opt_cfg_for(abstract_params(cfg))
    one, two = (hlo_cost.analyze(dryrun.count_train_step(cfg, opt, _batch(cfg, 2, 32)))
                for _ in range(2))
    assert one["flops"] > 0 and one["bytes"] > 0 and one["peak_bytes"] > 0
    assert one == two


COUNTED = ("flops", "bytes", "transcendentals", "elementwise_kernel_flops", "collective_bytes",
           "collectives", "collective_counts", "kernels", "peak_bytes", "argument_bytes",
           "temp_bytes")


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b", "deepseek-moe-16b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("dims,axes", [((2, 4), ("data", "model")),
                                       ((2, 2, 2), ("pod", "data", "model"))])
def test_one_signature_counts_what_every_position_counts(arch, dims, axes):
    """``plan=True`` runs one data shard and one optimizer position per
    signature and weights them; the full step runs every one."""
    cfg = get_smoke_config(arch)
    opt = dryrun._opt_cfg_for(abstract_params(cfg))
    mesh = make_mesh(dims, axes, "meta")
    batch = _batch(cfg, 8, 64)
    plan = hlo_cost.analyze(dryrun.count_train_step(cfg, opt, batch, mesh, plan=True))
    full = hlo_cost.analyze(dryrun.count_train_step(cfg, opt, batch, mesh, plan=False))
    assert {k: plan[k] for k in COUNTED} == {k: full[k] for k in COUNTED}
    assert plan["collective_bytes"] > 0


@pytest.mark.parametrize("arch,depth", [("qwen3-14b", 5), ("deepseek-moe-16b", 4),
                                        ("recurrentgemma-9b", 3)])
def test_depths_one_and_two_carry_on_to_the_full_depth(arch, depth):
    """The sweep counts the sharded step at main-stack depths 1 and 2 and
    carries the totals on: equal to counting every layer, the peak to
    within the allocator's 512-byte rounding of each storage."""
    cfg = dryrun.with_main_depth(get_smoke_config(arch), depth)
    opt = dryrun._opt_cfg_for(abstract_params(cfg))
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    batch = _batch(cfg, 4, 32)
    carried, _, depths = dryrun.count_train_cell(cfg, opt, batch, mesh)
    records = dryrun.count_train_step(cfg, opt, batch, mesh)
    full = hlo_cost.analyze(records)
    assert depths == [1, 2] and dryrun.main_depth(cfg) == depth
    for key in COUNTED[:8]:
        assert carried[key] == full[key], key
    storages = 4 * sum(1 for r in records if not r.get("nokernel")) + 1000
    assert abs(carried["peak_bytes"] - full["peak_bytes"]) <= 512 * storages


# ------------------------------------------------------ the serve step


def _serve_batch(cfg, kind, b=2, s=32):
    return input_specs(cfg, ShapeSpec("s", s, b, kind))


def _one_device_serve(cfg, kind, batch, max_len):
    params = abstract_params(cfg)
    if kind == "prefill":
        return hlo_cost.trace_ops(port_step.make_serve_prefill(cfg), params, batch)[1]
    cache = abstract_cache(cfg, next(iter(batch.values())).shape[0], max_len)
    cache["length"] = max_len - 1
    return hlo_cost.trace_ops(port_step.make_serve_step(cfg), params, cache, batch)[1]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", r_list_archs())
def test_serve_step_at_1x1_counts_the_one_device_step_exactly(arch, kind):
    """On a (1, 1) mesh the sharded serve step uses each parameter and
    cache block in place and runs the one-device step's ops: every count
    equal, the peak and the arguments included."""
    cfg = get_smoke_config(arch)
    batch = _serve_batch(cfg, kind)
    mesh = make_mesh((1, 1), ("data", "model"), "meta")
    got = hlo_cost.analyze(dryrun.count_serve_step(cfg, kind, batch, mesh, 32))
    want = hlo_cost.analyze(_one_device_serve(cfg, kind, batch, 32))
    assert {k: got[k] for k in COUNTED} == {k: want[k] for k in COUNTED}
    assert got["flops"] > 0 and got["collective_bytes"] == 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b", "deepseek-moe-16b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("dims,axes", [((2, 2), ("data", "model")),
                                       ((2, 2, 2), ("pod", "data", "model"))])
def test_serve_plan_counts_what_every_position_counts(arch, kind, dims, axes):
    """``plan=True`` runs one data shard per row count and weights it; the
    full step runs every one."""
    cfg = get_smoke_config(arch)
    batch = _serve_batch(cfg, kind, b=8)
    mesh = make_mesh(dims, axes, "meta")
    plan = hlo_cost.analyze(dryrun.count_serve_step(cfg, kind, batch, mesh, 32, plan=True))
    full = hlo_cost.analyze(dryrun.count_serve_step(cfg, kind, batch, mesh, 32, plan=False))
    assert {k: plan[k] for k in COUNTED[:8]} == {k: full[k] for k in COUNTED[:8]}
    assert plan["collective_bytes"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch,depth", [("qwen3-14b", 5), ("deepseek-moe-16b", 4)])
def test_serving_depths_one_and_two_carry_on_to_the_full_depth(arch, depth, kind):
    """On a mesh of several positions a serving cell is counted at
    main-stack depths 1 and 2 and carried on: equal to counting every
    layer, the peak within the allocator's 512-byte rounding of each
    storage.  On one position it is counted at full depth."""
    cfg = dryrun.with_main_depth(get_smoke_config(arch), depth)
    batch = _serve_batch(cfg, kind, b=4)
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    carried, _, depths = dryrun.count_serve_cell(cfg, kind, batch, mesh, 32)
    records = dryrun.count_serve_step(cfg, kind, batch, mesh, 32)
    full = hlo_cost.analyze(records)
    assert depths == [1, 2]
    for key in COUNTED[:8]:
        assert carried[key] == full[key], key
    storages = 4 * sum(1 for r in records if not r.get("nokernel")) + 1000
    assert abs(carried["peak_bytes"] - full["peak_bytes"]) <= 512 * storages
    one = make_mesh((1, 1), ("data", "model"), "meta")
    assert dryrun.count_serve_cell(cfg, kind, batch, one, 32)[2] == [depth]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_split_recurrent_cells_count_what_every_position_counts(kind):
    """mamba2's and recurrentgemma's smoke steps on (2, 2), split over
    ``model`` (heads, channels): one data shard per row count (``plan``)
    counts what every shard counts, copies between positions included;
    the counted full-sequence kernels run each position's share (K4 at
    ``H/tp`` heads a B/C row, K6 at ``R/tp`` channels, K3 on the hybrid's
    sequence blocks with its window)."""
    from repro_torch.kernels import _build

    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        calls = []

        def seen(name, inputs, outputs, attrs):
            calls.append((name, tuple(inputs[0].shape), attrs.get("heads_per_bc"),
                          attrs.get("window")))

        def count(plan):
            if kind == "train":
                opt = dryrun._opt_cfg_for(abstract_params(cfg))
                return dryrun.count_train_step(cfg, opt, _batch(cfg, 8, 64), mesh, plan=plan)
            return dryrun.count_serve_step(cfg, kind, _serve_batch(cfg, kind, b=8), mesh, 32,
                                           plan=plan)

        with _build.observe(seen):
            full = hlo_cost.analyze(count(False))
        plan = hlo_cost.analyze(count(True))
        assert {k: plan[k] for k in COUNTED[:8]} == {k: full[k] for k in COUNTED[:8]}, arch
        assert plan["collective_bytes"] > 0
        assert dryrun.ShardedServeStep(cfg, mesh).mixer == ("heads" if arch.startswith("mamba")
                                                            else "channels")
        if kind == "decode":
            continue  # one token: the recurrences step in plain PyTorch
        seq = 64 if kind == "train" else 32
        if arch.startswith("mamba"):
            heads = 2 * cfg.d_model // cfg.ssm_head_dim // 2
            k4 = {c for c in calls if c[0] == "ssd_scan"}
            assert k4 == {("ssd_scan", (4 * heads, seq, cfg.ssm_head_dim), heads, None)}, k4
        else:
            k6 = {c[1] for c in calls if c[0] == "rglru_scan"}
            assert k6 == {(4, seq, cfg.d_rnn // 2)}, k6
            k3 = {c[1][2] for c in calls if c[0] == "flash_attention"}
            w = seq // 2
            assert k3 == {w, 2 * w - max(0, w - cfg.window + 1)}, k3
            assert {c[3] for c in calls if c[0] == "flash_attention"} == {cfg.window}


def test_serving_cells_count_the_split_step(tmp_path):
    """A decode and a prefill cell on (2, 2): the record names the serve
    step and its split, counts copies between positions, and its per
    position cost is the mesh's total over its four positions."""
    for shape, attn in (("decode_32k", "heads"), ("prefill_32k", "heads")):
        rec = _port_cell("qwen2-7b", shape, "2,2", tmp_path)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["split"]["counted"].startswith("ShardedServeStep")
        assert (rec["split"]["attention"], rec["split"]["mlp"]) == (attn, "columns")
        assert "unsplit" not in json.dumps(rec)
        assert rec["cost_total"]["collective_bytes"] > 0
        assert rec["cost_analysis"]["flops"] == rec["cost_total"]["flops"] / 4


def test_moe_cells_record_the_expert_split(tmp_path):
    """deepseek-moe's train, prefill and decode cells on (2, 2): the record
    names the experts split over ``model``, attention by heads and the
    MLPs by columns, and counts copies between positions."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = _port_cell("deepseek-moe-16b", shape, "2,2", tmp_path)
        assert rec["status"] == "ok", rec.get("error")
        split = rec["split"]
        assert (split["experts"], split["attention"], split["mlp"], split["mixer"]) == (
            "experts", "heads", "columns", "whole"), shape
        assert rec["cost_total"]["collective_bytes"] > 0
        assert rec["cost_total"]["collectives"]["collective-permute"] > 0  # the slot maps


# ------------------------------------------------------- the launcher

_NO_JAX = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
           "from repro_torch.launch import dryrun; ")


def test_launcher_runs_the_reference_failing_cells_without_jax(tmp_path):
    """``tests/test_dryrun_smoke.py``'s three cells that the reference's
    launcher fails on this JAX, with its asserts, in a process where
    ``jax`` cannot be imported."""
    code = _NO_JAX + ";".join(
        f"dryrun.main({args!r})" for args in (
            ["--devices", "8", "--smoke", "--no-hlo", "--out", str(tmp_path), "--arch",
             "qwen3-14b", "--shape", "train_4k", "--mesh-shape", "2,4"],
            ["--devices", "8", "--smoke", "--no-hlo", "--out", str(tmp_path), "--arch",
             "recurrentgemma-9b", "--shape", "prefill_32k", "--mesh-shape", "2,4"],
            ["--devices", "8", "--smoke", "--no-hlo", "--out", str(tmp_path), "--arch",
             "qwen2-7b", "--shape", "train_4k", "--mesh-shape", "2,2,2"],
            ["--devices", "8", "--smoke", "--no-hlo", "--out", str(tmp_path), "--arch",
             "qwen2-7b", "--shape", "long_500k", "--mesh-shape", "2,2,2"],
        ))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "memory_analysis" in r.stdout and "cost_analysis" in r.stdout
    for arch, shape in (("qwen3-14b", "train_4k"), ("recurrentgemma-9b", "prefill_32k")):
        rec = json.loads((tmp_path / f"{arch}__{shape}__2x4.json").read_text())
        assert rec["status"] == "ok"
        assert rec["cost_analysis"]["flops"] > 0
    rec = json.loads((tmp_path / "qwen2-7b__train_4k__2x2x2.json").read_text())
    assert rec["status"] == "ok" and rec["split"]["attention"] == "heads"
    rec = json.loads((tmp_path / "qwen2-7b__long_500k__2x2x2.json").read_text())
    assert rec["status"] == "skip" and "full-attention" in rec["reason"]
    assert not list(tmp_path.glob("*.ops.jsonl.gz"))


def test_op_record_reads_back_to_the_same_totals(tmp_path):
    """Without ``--no-hlo`` the cell writes its op record in place of the
    reference's ``.hlo.gz``; ``analyze`` of the lines read back gives the
    record's per-device cost (a serving cell: one position's program)."""
    rec = _port_cell("mamba2-2.7b", "decode_32k", "1,1", tmp_path)
    rec2 = dryrun.run_cell("mamba2-2.7b", "decode_32k", make_mesh((1, 1), ("data", "model"),
                                                                   "meta"),
                           "1x1", str(tmp_path), smoke=True)
    assert rec2["cost_analysis"] == rec["cost_analysis"]
    got = hlo_cost.analyze(dryrun.read_ops(rec2["ops"]))
    assert got["flops"] == rec["cost_analysis"]["flops"]
    assert got["bytes"] == rec["cost_analysis"]["bytes accessed"]
    assert got["temp_bytes"] == rec["memory_analysis"]["temp_bytes"]
    assert rec["roofline"] == hlo_cost.roofline_terms(
        {"flops": got["flops"], "bytes": got["bytes"], "collective_bytes": 0.0})


def test_failed_cell_is_recorded_and_the_launcher_exits_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "plan_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--smoke", "--arch", "mamba2-2.7b", "--shape", "decode_32k",
                     "--mesh-shape", "1,1", "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "mamba2-2.7b__decode_32k__1x1.json").read_text())
    assert rec["status"] == "fail" and rec["error"] == "RuntimeError: planted"


# ------------------------------------------------ the meta route itself


def test_meta_route_allocates_the_card_scratch_and_notes_one_op():
    """K3's backward on ``meta``: the outputs in the card route's dtypes,
    the tensor-core scratch (lse and delta, and at head dim 256 the f32
    dK/dV partials) live inside the call, one noted kernel, and no
    plain-version body (no S×S scores)."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, s, d = 1, 16, 1, 4096, 256
    q = torch.empty((b, hq, s, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, hkv, s, d), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((b * hq, s), dtype=torch.float32, device="meta")
    before = fa.bwd_launches.value
    (dq, dk, dv), records = hlo_cost.trace_ops(fa.flash_attention_bwd, q, k, k, q, lse, q, True,
                                               2048)
    assert fa.bwd_launches.value == before  # nothing launched
    assert [(t.shape, t.dtype) for t in (dq, dk, dv)] == [(q.shape, q.dtype), (k.shape, k.dtype),
                                                          (k.shape, k.dtype)]
    ops = [r["op"] for r in records]
    assert ops.count("kernel.flash_attention_bwd") == 1
    assert not any(op in ops for op in ("aten.bmm", "aten.mm", "aten._softmax"))
    partials = 2 * b * hq * s * d * 4  # 128 MiB at recurrentgemma's [train] shape
    assert hlo_cost.analyze(records)["temp_bytes"] >= partials + q.nbytes


def test_cuda_route_still_raises_without_a_card():
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device()
    assert resolve_device("meta") == torch.device("meta")
    x = torch.empty((4, 128), device="meta")
    assert rn.rms_norm(x, torch.empty(128, device="meta")).device.type == "meta"
    with pytest.raises(ValueError, match="one CUDA device"):
        rn.rms_norm(x, torch.empty(128))


def test_gnn_mesh_step_notes_its_exchange_by_kind():
    """The GNN mesh step's copies between distinct positions, noted to the
    op record: the all_to_all's and the reduce-scatter's bytes are the
    step's own ``wire_bytes`` (whose formula ``test_torch_mesh.py`` holds
    to the reference)."""
    from repro_torch.dist import mesh as tmesh
    from repro_torch.graphs.synth import powerlaw_graph

    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    csr = powerlaw_graph(600, 6, seed=3)
    d, f = 16, 12
    rng = np.random.default_rng(0)
    plan = tmesh.build_combined_plan(csr, 4)
    step = tmesh.make_combined_layer_step(mesh)
    x = tmesh.shard_features(mesh, tmesh.pad_features(
        rng.standard_normal((600, d)).astype(np.float32), plan))
    w = torch.from_numpy(rng.standard_normal((d, f)).astype(np.float32))
    got = hlo_cost.analyze(hlo_cost.trace_ops(step, x, plan, w, torch.zeros(f))[1])
    assert got["collectives"]["all-to-all"] == step.wire_bytes.all_to_all > 0
    assert got["collectives"]["reduce-scatter"] == step.wire_bytes.reduce_scatter > 0
    assert got["collective_counts"]["all-to-all"] == 4 * 3 * 2  # S·(S-1) slabs per model shard
    assert got["flops"] == 0  # the CPU's plain versions: no op on a device, no noted kernel
