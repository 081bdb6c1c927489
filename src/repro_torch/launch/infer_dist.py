"""Sharded out-of-core inference launcher (and shard-worker entry point).

Coordinator mode (default): build or open a store, run a
``repro_torch.dist.DistSession`` over it, publish the final layer,
spot-check served rows, and — unless ``--no-check`` — verify
bit-identity against the single-machine ``AtlasSession`` on the same
graph (the exit code is non-zero on any mismatch)::

    PYTHONPATH=src python -m repro_torch.launch.infer_dist \
        --vertices 20000 --shards 2 --workers process --kind sage \
        [--device cpu] [--exchange mesh --workers thread \
         --mesh-devices cuda:0,cuda:0]

Runs on the GPU unless ``--device cpu`` is given; without a GPU the
default raises ``RuntimeError``.  ``--mesh-devices`` lists one torch
device per shard for ``--exchange mesh`` (default ``cuda:0 ..
cuda:S-1``).

Worker mode (``--worker``): one shard of one layer, spawned per layer by
the process-mode coordinator.  Streams the shard's source range, routes
cross-shard buckets through the file-backed ``LocalExchange``, barriers
its own write-back scheduler, and reports a JSON result file (with
``startup_seconds``, spawn to the start of its layer: interpreter,
imports, device context and weights); any failure exits nonzero after
flagging the exchange abort marker so peers fail fast instead of timing
out.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time
import traceback


def _worker_main(args) -> int:
    import numpy as np  # noqa: F401 — keep imports inside worker for fast --help

    from repro_torch.core.atlas import AtlasConfig, AtlasEngine
    from repro_torch.dist.exchange import LocalExchange
    from repro_torch.dist.partition import ShardPlan
    from repro_torch.dist.session import DistRunManifest
    from repro_torch.dist.worker import run_shard_layer
    from repro_torch.graphs.csr import degrees_from_csr
    from repro_torch.models.gnn import specs_from_numpy
    from repro_torch.obs.trace import Tracer
    from repro_torch.storage.layout import GraphStore
    from repro_torch.storage.spill import SpillFile, SpillSet

    exchange = LocalExchange(
        args.exchange_root, args.shards, timeout_s=args.exchange_timeout
    )
    try:
        store = GraphStore.open(args.store)
        manifest = DistRunManifest.load(args.manifest)
        cfg = AtlasConfig(**json.loads(args.config_json))
        with open(args.specs, "rb") as f:
            # numpy layer descriptions written by DistSession.infer
            specs = specs_from_numpy(pickle.load(f), device=AtlasEngine(cfg).device())
        plan = ShardPlan(
            store.num_vertices, args.shards,
            store_digest=store.ordering_digest,
        )
        plan.validate_store(store)
        csr = store.topology()
        in_deg, _ = degrees_from_csr(csr)
        layer = args.layer
        if layer == 0:
            spills = store.layer0_spills()
        else:
            spills = SpillSet()
            for p in manifest.spills[layer][args.shard]:
                spills.add(SpillFile.open(p))
        tracer = Tracer() if args.trace else None
        startup = None if args.spawned_at is None else time.time() - args.spawned_at
        layer_spills, info = run_shard_layer(
            csr, in_deg, spills, specs[layer], args.out_dir, layer,
            args.shard, plan, exchange, config=cfg, tracer=tracer,
        )
        info["startup_seconds"] = startup
        if args.trace:
            tracer.export(args.trace)
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f, indent=2)
        os.replace(tmp, args.result)
        return 0
    except BaseException as e:  # noqa: BLE001 — worker boundary
        # flag the abort before dying so peer collect() polls fail fast
        try:
            exchange.abort(
                f"shard {args.shard} layer {args.layer}: "
                f"{type(e).__name__}: {e}"
            )
        except BaseException:
            pass
        traceback.print_exc()
        return 1


def _coordinator_main(args) -> int:
    import numpy as np

    from repro_torch.core.atlas import AtlasConfig, spills_to_dense
    from repro_torch.device import resolve_device
    from repro_torch.dist.session import DistSession
    from repro_torch.exact import exact_graph_and_specs
    from repro_torch.session import AtlasSession
    from repro_torch.storage.layout import GraphStore

    backend = resolve_device(args.device).type  # no GPU for cuda: raise up front
    mesh_devices = args.mesh_devices.split(",") if args.mesh_devices else None

    with tempfile.TemporaryDirectory() as td:
        workdir = args.workdir or td
        csr, feats, specs = exact_graph_and_specs(
            args.vertices, args.feat_dim, kind=args.kind, seed=args.seed
        )
        store = GraphStore.create(
            os.path.join(workdir, "store"), csr, feats, num_partitions=4
        )
        cfg = AtlasConfig(
            chunk_bytes=args.chunk_bytes, hot_slots=args.hot_slots,
            trace=bool(args.trace), backend=backend,
        )
        with DistSession(
            store, shards=args.shards, config=cfg, exchange=args.exchange,
            workers=args.workers, workdir=os.path.join(workdir, "dist"),
            mesh_devices=mesh_devices,
        ) as dist:
            t0 = time.perf_counter()
            result = dist.infer(specs)
            wall = time.perf_counter() - t0
            dense_dist = spills_to_dense(
                result.final.spills, store.num_vertices, result.final.dim
            )
            version = dist.publish(result.final)
            with dist.reader(result.final.layer) as reader:
                probe = np.arange(0, store.num_vertices, 97)
                served = reader.lookup(probe)
        report = {
            "vertices": store.num_vertices,
            "shards": args.shards,
            "workers": args.workers,
            "exchange": args.exchange,
            "device": backend,
            "layers": len(specs),
            "infer_seconds": wall,
            "epoch": version.epoch,
            "served_rows": int(len(served)),
            "shard_reports": result.shard_reports,
        }
        if not args.no_check:
            with AtlasSession(
                store, config=AtlasConfig(
                    chunk_bytes=args.chunk_bytes, hot_slots=args.hot_slots,
                    backend=backend,
                ),
                workdir=os.path.join(workdir, "single"),
            ) as single:
                ref = single.infer(specs)
                dense_ref = spills_to_dense(
                    ref.final.spills, store.num_vertices, ref.final.dim
                )
            identical = bool(np.array_equal(dense_dist, dense_ref))
            served_ok = bool(np.array_equal(served, dense_ref[probe]))
            report["bit_identical"] = identical
            report["served_identical"] = served_ok
            if not (identical and served_ok):
                print(json.dumps(report, indent=2))
                print("FAIL: dist output differs from single-machine run")
                return 1
        print(json.dumps(report, indent=2))
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true", help="shard-worker mode")
    # worker-mode arguments (supplied by the coordinator)
    ap.add_argument("--store", help="graph store root")
    ap.add_argument("--manifest", help="dist run manifest path")
    ap.add_argument("--specs", help="pickled layer-spec stack")
    ap.add_argument("--config-json", help="AtlasConfig as JSON")
    ap.add_argument("--layer", type=int, default=0)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--out-dir", help="shard output directory")
    ap.add_argument("--exchange-root", help="LocalExchange directory")
    ap.add_argument("--exchange-timeout", type=float, default=120.0)
    ap.add_argument("--result", help="worker result JSON path")
    ap.add_argument("--spawned-at", type=float, default=None,
                    help="coordinator's time.time() at spawn (startup_seconds)")
    # coordinator-mode arguments
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--feat-dim", type=int, default=16)
    ap.add_argument("--kind", choices=["gcn", "sage"], default="gcn")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--exchange", choices=["local", "mesh"], default="local")
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated torch device per shard for "
                         "--exchange mesh (default cuda:0..cuda:S-1)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where aggregation and transform run (K1/K2 on "
                         "cuda, their plain versions on cpu)")
    ap.add_argument("--workers", choices=["thread", "process"], default="process")
    ap.add_argument("--chunk-bytes", type=int, default=1 << 20)
    ap.add_argument("--hot-slots", type=int, default=None)
    ap.add_argument("--workdir", default=None, help="keep run state here")
    ap.add_argument("--trace", default=None,
                    help="worker: trace output path; coordinator: any value enables tracing")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the single-machine bit-identity check")
    args = ap.parse_args(argv)
    if args.worker:
        return _worker_main(args)
    return _coordinator_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
