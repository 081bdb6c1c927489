"""Billion-scale GNN dry-run: plan one broadcast layer of the mesh step
(``repro_torch.dist.mesh``) for the paper's largest workload (IGB-Full
scale: 269M vertices, 4B edges, 1024-dim features) on the production
meshes, on no device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn [--mesh single|multi|both]
        [--mesh-shape 4,2] [--out results/dryrun_gnn]

Two variants per mesh:
  * baseline  — per-edge messages through the all_to_all;
  * combined  — source-side combining: wire volume E -> E/reuse, with
    ``reuse`` measured on a down-scaled synthetic power-law graph of the
    same average degree and shard count.

Each writes ``gnn__<mesh>__<variant>.json``: the layer's sizes, and under
``memory_analysis`` the per-device bytes of the step's inputs and output
in the dtypes a run at this scale would use (bf16 features and weights,
int32 indices, f32 edge weights).  In place of a compiler's cost
analysis, ``cost`` holds, per device: ``wire_bytes`` (the all_to_all's
slabs and the reduce-scatter's f32 column blocks sent to other
positions), ``message_bytes`` (the source side's f32 slab ``[S·rows,
D/M]``, the largest message buffer a step holds), ``agg_flops`` (two per
message element: per edge and feature on the source side, per received
row and feature on the destination side) and ``gemm_flops`` (the
graduation's product on ``meta`` tensors, counted by
``torch.utils.flop_counter.FlopCounterMode``).  Nothing is allocated at
this scale and no device is touched: the mesh holds device names only.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.dist.mesh import build_combined_plan, wire_bytes
from repro_torch.graphs.synth import powerlaw_graph
from repro_torch.launch.mesh import make_mesh, make_production_mesh

# IGB-Full (paper Table 1): 269M vertices, 4B edges, 1024-dim features
GNN_SCALE = {"V": 269_000_000, "E": 4_000_000_000, "D": 1024, "F": 128}
BF16, INT32, F32 = 2, 4, 4  # bytes of the step's feature, index and weight dtypes


def measured_reuse(num_shards: int, avg_degree: int) -> float:
    """Combining factor measured on a scaled-down power-law graph."""
    csr = powerlaw_graph(200_000, avg_degree, seed=1)
    plan = build_combined_plan(csr, num_shards, kind="gcn")
    return plan.reuse


def _gemm_flops(rows: int, k: int, f: int) -> int:
    """FLOPs of one position's graduation product ``[rows, k] @ [k, f]``."""
    x = torch.empty((rows, k), dtype=torch.bfloat16, device="meta")
    w = torch.empty((k, f), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as counter:
        torch.mm(x, w)
    return counter.get_total_flops()


def plan_gnn_cell(mesh, tag: str, combine: bool, outdir: str, scale=GNN_SCALE,
                  reuse_cache: dict | None = None) -> dict:
    """One (mesh, variant) record, written to ``outdir``.  ``reuse_cache``
    maps (shards, average degree) to a measured reuse, so meshes that
    ask for the same one build its plan once."""
    s, m = mesh.num_shards, mesh.model_size
    v, e, d, f_out = scale["V"], scale["E"], scale["D"], scale["F"]
    if d % m or f_out % m:
        raise ValueError(f"D={d} and F={f_out} must divide by the model axis size {m}")
    vl = -(-v // s)
    eb = -(-e // (s * s))
    dl, fm = d // m, f_out // m
    rec = {
        "arch": "atlas-gnn-igbfull", "shape": "layer_bcast",
        "mesh": tag, "combine": combine,
        "V": v, "E": e, "D": d, "F": f_out, "shards": s,
        "bucket": eb, "v_local": vl,
    }
    # per device: feats [v_local, D/M], src_local and weight [S, Eb], then
    # edge_slot [S, Eb] and slot_dst [S, U] (combined) or dst_local [S, Eb]
    arg = vl * dl * BF16 + s * eb * (INT32 + F32) + s * eb * INT32
    rows = eb
    if combine:
        key = (min(s, 16), max(2, e // v))
        cache = {} if reuse_cache is None else reuse_cache
        if key not in cache:
            cache[key] = measured_reuse(*key)
        reuse = cache[key]
        u = max(1, int(eb / reuse)) + 1
        rec["reuse"] = reuse
        rec["slots"] = u
        arg += s * u * INT32
        rows = u
    arg += dl * f_out * BF16 + fm * BF16  # w_agg [D/M, F], bias [F/M]
    rec["memory_analysis"] = {
        "argument_bytes": arg,
        "output_bytes": vl * fm * BF16,
    }
    wire = wire_bytes(s, m, rows, d, BF16, vl, f_out)
    rec["cost"] = {
        "wire_bytes": wire.total // (s * m),
        "message_bytes": s * rows * dl * F32,
        "agg_flops": 2 * s * eb * dl + 2 * s * rows * dl,
        "gemm_flops": _gemm_flops(vl, dl, f_out),
    }
    rec["status"] = "ok"
    name = f"gnn__{tag}__{'combined' if combine else 'baseline'}"
    with open(os.path.join(outdir, f"{name}.json"), "w") as fh:
        json.dump(rec, fh, indent=2)
    print(f"[gnn-dryrun] {name}: ok, {rec['memory_analysis']} {rec['cost']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--out", default="results/dryrun_gnn")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = []
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split(","))
        axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
        meshes.append((make_mesh(dims, axes), "x".join(map(str, dims))))
    else:
        if args.mesh in ("single", "both"):
            meshes.append((make_production_mesh(multi_pod=False), "16x16"))
        if args.mesh in ("multi", "both"):
            meshes.append((make_production_mesh(multi_pod=True), "2x16x16"))

    reuse_cache: dict = {}
    return [plan_gnn_cell(mesh, tag, combine, args.out, reuse_cache=reuse_cache)
            for mesh, tag in meshes for combine in (False, True)]


if __name__ == "__main__":
    main()
