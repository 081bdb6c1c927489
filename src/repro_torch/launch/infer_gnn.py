"""GNN inference launcher: the paper's workload end-to-end.

Synthetic graphs stand in for Papers/MAG/IGB at laptop scale; pass
--vertices/--degree/--dim to size up.  ``--reorder`` selects the store's
vertex ordering (paper §3.8): the *store build* relabels topology and
features into storage order and persists the permutation sidecar, the
engine runs purely in internal ids, and ``--verify`` / ``--serve``
operate in the caller's original (external) ids throughout — served
rows are bit-for-bit independent of the physical layout.

    PYTHONPATH=src python -m repro_torch.launch.infer_gnn --model sage \
        --vertices 50000 --hot-mib 32 --reorder at [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU the
default raises ``RuntimeError``.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.device import resolve_device
from repro_torch.graphs.synth import make_features, powerlaw_graph
from repro_torch.models.gnn import dense_reference, init_gnn_params
from repro_torch.session import AtlasSession
from repro_torch.storage.layout import GraphStore


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gcn", choices=["gcn", "sage", "gin"])
    ap.add_argument("--vertices", type=int, default=50_000)
    ap.add_argument("--degree", type=int, default=12)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hot-mib", type=int, default=64)
    ap.add_argument("--chunk-mib", type=int, default=8)
    ap.add_argument("--reorder", default="at", choices=["og", "rnd", "at"],
                    help="store-build vertex ordering (og=original, "
                         "rnd=random, at=the paper's greedy order)")
    ap.add_argument("--eviction", default="at", choices=["at", "lru", "rnd"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where aggregation and transform run (K1/K2 on "
                         "cuda, their plain versions on cpu)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--serve", action="store_true",
                    help="publish the final layer and sanity-serve lookups")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # no GPU for cuda: raise up front

    csr = powerlaw_graph(args.vertices, args.degree, seed=1,
                         self_loops=(args.model == "gcn"))
    feats = make_features(args.vertices, args.dim, seed=2)
    dims = [args.dim] + [args.hidden] * (args.layers - 1) + [args.hidden]
    specs = init_gnn_params(args.model, dims, seed=3)

    with tempfile.TemporaryDirectory() as td:
        wd = args.workdir or td
        # the ordering is a store-build option: GraphStore.create relabels
        # topology + features into storage order and persists the
        # permutation sidecar; everything downstream sees internal ids
        t0 = time.time()
        store = GraphStore.create(
            f"{wd}/store", csr, feats, num_partitions=8, order=args.reorder
        )
        print(f"[infer-gnn] store build (order={store.ordering_name}, "
              f"digest {store.ordering_digest}): {time.time() - t0:.1f}s "
              f"(one-time, amortized across layers/runs)")
        cfg = AtlasConfig(chunk_bytes=args.chunk_mib << 20,
                          hot_bytes=args.hot_mib << 20,
                          eviction=args.eviction,
                          backend=device.type)
        with AtlasSession(store, config=cfg, workdir=f"{wd}/work") as session:
            t0 = time.time()
            result = session.infer(specs)
            wall = time.time() - t0
            for m in result.metrics:
                print(f"[infer-gnn] layer {m.layer}: {m.seconds:.1f}s "
                      f"read={m.bytes_read >> 20}MiB evict={m.evictions} "
                      f"reload={m.reloads}")
            print(f"[infer-gnn] total {wall:.1f}s for "
                  f"{csr.num_vertices} vertices / {csr.num_edges} edges "
                  f"on {device.type}")
            final = result.final
            if args.verify:
                # engine output rows are in internal (storage) order;
                # translate back so row e compares against external
                # vertex e of the unordered reference
                out = spills_to_dense(final.spills, csr.num_vertices, final.dim)
                out = out[store.to_internal(np.arange(csr.num_vertices))]
                ref = dense_reference(csr, feats, specs, device=device)
                err = np.abs(out - ref).max(axis=1).mean()
                print(f"[infer-gnn] mean-max-abs vs reference: {err:.2e}")
                assert err < 1e-4
            if args.serve:
                published = session.publish(final)
                with session.reader(final.layer, cache_bytes=8 << 20) as reader:
                    # lookups speak external ids; the reader translates
                    # through the store's permutation sidecar
                    sample = np.random.default_rng(0).integers(
                        0, csr.num_vertices, size=1024
                    )
                    rows = reader.lookup(sample)
                    print(f"[infer-gnn] served {len(rows)} lookups from "
                          f"version v{published.epoch} "
                          f"({reader.blocks_read} cold block reads)")


if __name__ == "__main__":
    main()
