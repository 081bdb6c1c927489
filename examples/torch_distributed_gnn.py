"""Distributed ATLAS on the PyTorch/CUDA port: broadcast GNN inference
over a device mesh.

Runs the push-SpMM (vertex ranges over `data`, feature dim over `model`)
with source-side combining on a (4, 2) mesh whose eight positions share
one device, K1 and K2 doing each position's work, and verifies against
the in-memory oracle.

    PYTHONPATH=src python examples/torch_distributed_gnn.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU the
default raises ``RuntimeError``.
"""

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.mesh import (
    build_combined_plan,
    gather_shards,
    make_combined_layer_step,
    pad_features,
    shard_features,
)
from repro_torch.graphs.synth import make_features, powerlaw_graph
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import dense_reference, init_gnn_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mesh = make_mesh((4, 2), ("data", "model"), devices=[str(device)] * 8)
    print(f"== mesh {dict(zip(mesh.axis_names, mesh.shape))} over "
          f"{len(mesh.devices)} devices ({device})")
    v, d = 4000, 32
    csr = powerlaw_graph(v, 8, seed=3, self_loops=True)
    feats = make_features(v, d, seed=4)
    specs = init_gnn_params("gcn", [d, 24, 16], seed=5)

    plan = build_combined_plan(csr, 4, kind="gcn")
    print(f"== source-side combining: reuse factor {plan.reuse:.2f} "
          f"(wire volume /{plan.reuse:.2f})")

    x = shard_features(mesh, pad_features(feats, plan))
    for spec in specs:
        step = make_combined_layer_step(mesh, activation=spec.activation)
        w = torch.from_numpy(spec.params["w"])
        b = torch.from_numpy(spec.params["b"])
        x = step(x, plan, w, b)

    out = gather_shards(x).numpy()[:v]
    ref = dense_reference(csr, feats, specs, device=device)
    err = float(np.abs(out - ref).max())
    print(f"== max error vs oracle: {err:.2e}")
    assert err < 1e-4
    print("== OK")


if __name__ == "__main__":
    main()
