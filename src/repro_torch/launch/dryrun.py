"""Multi-pod dry-run: plan every (arch, shape, mesh) cell on no device, the
counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A|all] [--shape S|all]
        [--mesh single|multi|both] [--mesh-shape 2,4] [--smoke] [--out DIR] [--no-hlo]

The reference lowers and compiles each cell's step with XLA and reads its
``memory_analysis`` and ``cost_analysis``.  The port builds the same step
on the ``meta`` device (shapes and dtypes, no memory) and counts it as it
runs (``repro_torch.perf.hlo_cost``): FLOPs, bytes, transcendentals, the
copies between mesh positions, and the bytes live at every op.  Each
cell writes ``{arch}__{shape}__{mesh}.json``:

  * ``status``: ``ok``, ``skip`` (with the reference's reason) or ``fail``
    (with the error; the launcher then exits 1);
  * ``params`` and, for train cells, ``moment_dtype`` (bf16 moments above
    ``BIG_MODEL_PARAMS``, as the reference);
  * ``memory_analysis``: ``argument_bytes`` and ``output_bytes`` of one
    mesh position, from the placements (``distributed/sharding.py``):
    the train state, batch and metrics, or the parameters, cache, batch
    and logits (``_logits_sharding``); ``temp_bytes`` and ``peak_bytes``
    of the counted program (``split`` says which);
  * ``cost_analysis``: ``flops``, ``bytes accessed`` and
    ``transcendentals`` per position, and ``cost_total`` the mesh's;
  * ``roofline``: ``hlo_cost.roofline_terms`` of the per-position cost at
    the H100's terms;
  * ``split``: what was counted.  Train cells run ``ShardedTrainStep``
    over the whole mesh in one process, one data shard per row count and
    one optimizer position per set of block shapes, weighted by how many
    run alike (``plan=True``), at main-stack depths 1 and 2, carried on
    linearly to the config's depth (``depths_counted``; every layer runs
    the same ops); attention splits its heads (or query rows) and the
    MLPs their columns over ``model``, the recurrent mixers their heads or
    channels (``mixer``) and the moe family its experts (``experts``)
    where they divide ``model``.  Prefill and decode cells
    run ``ShardedServeStep`` over the whole mesh the same way (one data
    shard per row count, ``plan=True``, depths 1 and 2 carried on; on a
    one-position mesh at the config's full depth, the one-device step's
    program op for op), split as the train cells with the cache split by
    sequence, decode attending over each position's block of slots; a
    moe config whose experts do not divide ``model`` runs whole at each
    data shard's first position.  Per position is the mesh's total over
    its positions;
  * ``ops``: the op record, ``{cell}.ops.jsonl.gz``, written in place of
    the reference's ``.hlo.gz`` unless ``--no-hlo``.

``--devices`` is accepted and ignored: the planner touches no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import (
    SHAPES,
    get_config,
    get_smoke_config,
    input_specs,
    list_archs,
    shape_applicable,
)
from repro_torch.distributed.sharding import (
    Placement,
    ShardedTensor,
    axis_size,
    batch_shardings,
    cache_shardings,
    dp_axes,
    param_shardings,
    tree_paths,
)
from repro_torch.distributed.spmd import (
    ShardedServeStep,
    ShardedTrainStep,
    cache_placements,
    state_shardings,
)
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.perf import hlo_cost
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import (
    abstract_cache,
    abstract_params,
    abstract_train_state,
    make_train_step,
)

BIG_MODEL_PARAMS = 100e9  # bf16 optimizer moments above this (arctic-480b)


def _param_count(tree) -> int:
    return sum(t.numel() for _, t in tree_paths(tree))


def _opt_cfg_for(params_abs) -> AdamWConfig:
    n = _param_count(params_abs)
    return AdamWConfig(moment_dtype="bfloat16" if n > BIG_MODEL_PARAMS else "float32")


def _logits_sharding(mesh, batch: int, vocab: int) -> Placement:
    dp = dp_axes(mesh)
    bax = dp if batch % axis_size(mesh, dp) == 0 else None
    vax = "model" if vocab % axis_size(mesh, "model") == 0 else None
    return Placement(mesh, (bax, vax))


def _block_bytes(t, placement: Placement) -> int:
    """Bytes of ``t``'s block at position 0 (every position's block has
    its size: a placement splits only dims that divide)."""
    if not isinstance(t, torch.Tensor):
        return 0  # the cache's length: a Python int
    region = placement.block(tuple(t.shape), 0)
    return math.prod(r.stop - r.start for r in region) * t.element_size()


def _placed_bytes(tree, placements) -> int:
    """One position's bytes of a tree placed by a matching tree."""
    if isinstance(tree, dict):
        return sum(_placed_bytes(v, placements[k]) for k, v in tree.items())
    return _block_bytes(tree, placements)


def _meta_mesh(mesh):
    return make_mesh(mesh.shape, mesh.axis_names, "meta")


def count_train_step(cfg, opt_cfg, batch: dict, mesh=None, *, plan: bool = True) -> list:
    """``hlo_cost.trace_ops``' records of one train step on ``meta``: the
    one-device step (``make_train_step``) without ``mesh``, else
    ``ShardedTrainStep`` over ``mesh``'s positions (``plan``: one data
    shard per row count, one optimizer position per set of block shapes)."""
    state = abstract_train_state(cfg, opt_cfg)
    if mesh is None:
        return hlo_cost.trace_ops(make_train_step(cfg, opt_cfg), state, batch)[1]
    mesh = _meta_mesh(mesh)
    step = ShardedTrainStep(cfg, opt_cfg, mesh, plan=plan)
    return hlo_cost.trace_ops(step, _meta_shards(state, state_shardings(mesh, state)), batch)[1]


def _meta_shards(tree, placements):
    """``shard_tree`` on ``meta``: each position's block a tensor of its own
    (a placement's blocks all have one shape)."""
    if isinstance(tree, dict):
        return {k: _meta_shards(v, placements[k]) for k, v in tree.items()}
    shape = tuple(tree.shape)
    block = [r.stop - r.start for r in placements.block(shape, 0)]
    return ShardedTensor(placements, shape, [torch.empty(block, dtype=tree.dtype, device="meta")
                                             for _ in range(placements.mesh.size)])


def main_depth(cfg) -> int:
    """Layers of the config's main stack: the MoE blocks after the leading
    dense ones, the hybrid family's superblocks, else every layer."""
    if cfg.family == "moe":
        return cfg.num_layers - cfg.first_k_dense
    if cfg.family == "hybrid":
        return cfg.num_layers // 3
    return cfg.num_layers


def with_main_depth(cfg, depth: int):
    """``cfg`` with ``depth`` layers in its main stack, the rest kept."""
    if cfg.family == "moe":
        return dataclasses.replace(cfg, num_layers=cfg.first_k_dense + depth)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=3 * depth + cfg.num_layers % 3)
    return dataclasses.replace(cfg, num_layers=depth)


def _affine(one, two, depth: int):
    """The value at ``depth`` of what is ``one`` at depth 1 and ``two`` at
    depth 2, growing by the same step every layer (dicts key by key)."""
    if isinstance(one, dict):
        return {k: _affine(one[k], two[k], depth) for k in one}
    return one + (depth - 1) * (two - one)


def _carried(count, cfg) -> tuple[dict, list, list]:
    """``hlo_cost.analyze`` of ``count(cfg)``'s records, the records counted
    last, and the main-stack depths counted.  Past two layers the program
    is counted at depths 1 and 2 and the totals carried on linearly: every
    layer of a stack runs the same ops, so the FLOPs, bytes, copies and
    calls are exact; ``peak_bytes`` is exact up to the 512-byte rounding
    of each storage."""
    depth = main_depth(cfg)
    if depth <= 2:
        records = count(cfg)
        return hlo_cost.analyze(records), records, [depth]
    one = hlo_cost.analyze(count(with_main_depth(cfg, 1)))
    records = count(with_main_depth(cfg, 2))
    two = hlo_cost.analyze(records)
    totals = _affine({k: v for k, v in one.items() if k != "num_computations"},
                     {k: v for k, v in two.items() if k != "num_computations"}, depth)
    totals["num_computations"] = two["num_computations"]
    return totals, records, [1, 2]


def count_train_cell(cfg, opt_cfg, batch: dict, mesh) -> tuple[dict, list, list]:
    """The sharded train step over ``mesh`` (plan mode), counted by
    ``_carried``."""
    return _carried(lambda c: count_train_step(c, opt_cfg, batch, mesh), cfg)


def train_argument_bytes(cfg, opt_cfg, mesh, batch: dict) -> int:
    """One position's bytes of a train step's arguments: its blocks of the
    parameters and both moments, the replicated int32 step, and its
    block of each batch tensor."""
    params = abstract_params(cfg)
    placements = param_shardings(mesh, params)
    item = torch.empty((), dtype=getattr(torch, opt_cfg.moment_dtype)).element_size()
    moments = 2 * sum(_block_bytes(t, pl) // t.element_size() * item
                      for (_, t), (_, pl) in zip(tree_paths(params), tree_paths(placements)))
    return (_placed_bytes(params, placements) + moments + 4
            + _placed_bytes(batch, batch_shardings(mesh, batch)))


def count_serve_step(cfg, kind: str, batch: dict, mesh, max_len: int, *,
                     plan: bool = True, length: int | None = None) -> list:
    """``hlo_cost.trace_ops``' records on ``meta`` of one ``ShardedServeStep``
    call over ``mesh``'s positions (``plan``: one data shard per row count):
    the prefill of ``batch``, or (``kind`` ``"decode"``) a decode step of
    ``batch`` (one token a row) into a cache of ``max_len`` slots filled to
    ``length`` (default: all but the last).  The length picks the block
    that takes the new keys and values, and so which copies it needs."""
    mesh = _meta_mesh(mesh)
    params = abstract_params(cfg)
    params = _meta_shards(params, param_shardings(mesh, params))
    step = ShardedServeStep(cfg, mesh, plan=plan)
    if kind == "prefill":
        return hlo_cost.trace_ops(step.prefill, params, batch)[1]
    rows = next(iter(batch.values())).shape[0]
    cache = abstract_cache(cfg, rows, max_len)
    cache = {**_meta_shards({k: v for k, v in cache.items() if k != "length"},
                            cache_placements(mesh, cache)),
             "length": max_len - 1 if length is None else length}
    return hlo_cost.trace_ops(step.decode, params, cache, batch)[1]


def count_serve_cell(cfg, kind: str, batch: dict, mesh, max_len: int) -> tuple[dict, list, list]:
    """The serve step over ``mesh`` (plan mode), counted by ``_carried``, or
    on a one-position mesh at the config's full depth, op for op the
    one-device step's program."""
    def count(c):
        return count_serve_step(c, kind, batch, mesh, max_len)

    if mesh.size == 1:
        records = count(cfg)
        return hlo_cost.analyze(records), records, [main_depth(cfg)]
    return _carried(count, cfg)


def _split(cfg, mesh, shape) -> dict:
    if shape.kind != "train":
        step = ShardedServeStep(cfg, _meta_mesh(mesh))
        attn, mlp = (step.modes(shape.seq_len) if shape.kind == "prefill"
                     else (step.attention, step.mlp))
        return {"counted": "ShardedServeStep over every position in one process, one data "
                           "shard per row count", "attention": attn, "mlp": mlp,
                "mixer": step.mixer, "experts": step.experts}
    step = ShardedTrainStep(cfg, AdamWConfig(), _meta_mesh(mesh))
    attn, mlp = step.modes(shape.seq_len)
    return {"counted": "ShardedTrainStep over every position in one process, one data shard "
                       "per row count, one optimizer position per set of block shapes",
            "attention": attn, "mlp": mlp, "mixer": step.mixer, "experts": step.experts}


def plan_cell(cfg, shape, mesh) -> tuple[dict, list]:
    """The record's planned fields for one cell, and the counted records."""
    params_abs = abstract_params(cfg)
    params_sh = param_shardings(mesh, params_abs)
    meta = {"params": _param_count(params_abs)}
    specs = input_specs(cfg, shape)
    batch_bytes = _placed_bytes(specs, batch_shardings(mesh, specs))
    positions = mesh.size

    if shape.kind == "train":
        opt_cfg = _opt_cfg_for(params_abs)
        meta["moment_dtype"] = opt_cfg.moment_dtype
        totals, records, depths = count_train_cell(cfg, opt_cfg, specs, mesh)
        arg = train_argument_bytes(cfg, opt_cfg, mesh, specs)
        out = arg - batch_bytes + 3 * 4  # the state, and the metrics: loss, grad_norm, lr
    else:
        params_bytes = _placed_bytes(params_abs, params_sh)
        logits_sh = _logits_sharding(mesh, shape.global_batch, cfg.vocab_size)
        logits = torch.empty((shape.global_batch, cfg.vocab_size), dtype=torch.float32,
                             device="meta")
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cache_bytes = _placed_bytes(cache, cache_shardings(mesh, cache))
        arg = params_bytes + batch_bytes + (cache_bytes if shape.kind == "decode" else 0)
        out = _block_bytes(logits, logits_sh) + cache_bytes
        totals, records, depths = count_serve_cell(cfg, shape.kind, specs, mesh, shape.seq_len)
    per = {k: totals[k] / positions for k in ("flops", "bytes", "transcendentals",
                                              "collective_bytes")}
    rec = dict(meta)
    rec["memory_analysis"] = {"argument_bytes": arg, "output_bytes": out,
                              "temp_bytes": totals["temp_bytes"],
                              "peak_bytes": totals["peak_bytes"]}
    rec["cost_analysis"] = {"flops": per["flops"], "bytes accessed": per["bytes"],
                            "transcendentals": per["transcendentals"]}
    rec["cost_total"] = {k: totals[k] for k in ("flops", "bytes", "collective_bytes")}
    rec["cost_total"]["collectives"] = totals["collectives"]
    rec["cost_total"]["kernels"] = totals["kernels"]
    rec["roofline"] = hlo_cost.roofline_terms(
        {"flops": per["flops"], "bytes": per["bytes"],
         "collective_bytes": per["collective_bytes"]})
    rec["split"] = _split(cfg, mesh, shape)
    rec["split"]["depths_counted"] = depths
    return rec, records


def write_ops(path: str, records) -> None:
    with gzip.open(path, "wt") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")


def read_ops(path: str) -> list[dict]:
    with gzip.open(path, "rt") as fh:
        return [json.loads(line) for line in fh]


def run_cell(arch, shape_name, mesh, mesh_tag, outdir, smoke=False, save_ops=True):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    cell_id = f"{arch}__{shape_name}__{mesh_tag}"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "mesh_shape": dict(zip(mesh.axis_names, mesh.shape)), "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skip"
        rec["reason"] = reason
        print(f"[dryrun] SKIP {cell_id}: {reason}")
        return rec

    t0 = time.time()
    try:
        planned, records = plan_cell(cfg, shape, mesh)
        rec.update(planned)
        rec["plan_s"] = round(time.time() - t0, 2)
        print(f"[dryrun] {cell_id} memory_analysis:", rec["memory_analysis"])
        print(f"[dryrun] {cell_id} cost_analysis:", rec["cost_analysis"])
        if save_ops:
            path = os.path.join(outdir, f"{cell_id}.ops.jsonl.gz")
            write_ops(path, records)
            rec["ops"] = path
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    rec["total_s"] = round(time.time() - t0, 2)
    print(f"[dryrun] {cell_id}: {rec['status']} ({rec['total_s']}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run on the meta device")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--devices", type=int, default=512,
                    help="accepted for the reference's command line; no device is used")
    ap.add_argument("--mesh-shape", default=None,
                    help="override, e.g. '2,4' or '2,2,2' (smoke tests)")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-hlo", action="store_true", help="write no op record")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = []
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
        meshes.append((make_mesh(dims, axes, "meta"), "x".join(map(str, dims))))
    else:
        if args.mesh in ("single", "both"):
            meshes.append((make_production_mesh(multi_pod=False, devices="meta"), "16x16"))
        if args.mesh in ("multi", "both"):
            meshes.append((make_production_mesh(multi_pod=True, devices="meta"), "2x16x16"))

    t0 = time.time()
    results = []
    for mesh, tag in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh, tag, args.out, smoke=args.smoke,
                               save_ops=not args.no_hlo)
                results.append(rec)
                path = os.path.join(args.out,
                                    f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"/ {len(results)} cells in {time.time() - t0:.1f}s")
    if n_fail:
        for r in results:
            if r["status"] == "fail":
                print("  FAIL", r["arch"], r["shape"], r["mesh"], "->", r["error"])
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
