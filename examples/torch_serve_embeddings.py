"""Serve final-layer GNN embeddings of the PyTorch/CUDA port straight from
the engine's spill set.

Runs the out-of-core engine, publishes the final layer as an
epoch-numbered *servable version* (one-time compaction into
block-indexed files), and answers batched vertex queries through the
sharded page cache — without ever materialising the dense [V, d]
embedding matrix.  Then demonstrates the versioning contract: a reader
opened before a re-publish keeps serving its pinned version
bit-identically, and the stale version is garbage-collected once the
reader closes.

    PYTHONPATH=src python examples/torch_serve_embeddings.py [--device cpu]

Inference runs on the GPU unless ``--device cpu`` is given; without a
GPU the default raises ``RuntimeError``.  Serving is host code.
"""

import argparse
import tempfile
import time

import numpy as np

from repro_torch.core.atlas import AtlasConfig
from repro_torch.device import resolve_device
from repro_torch.graphs.synth import make_features, powerlaw_graph
from repro_torch.models.gnn import init_gnn_params
from repro_torch.session import AtlasSession
from repro_torch.storage.layout import GraphStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    v, d = 50_000, 32
    print(f"== inference: {v} vertices, 2-layer GCN on {device.type}")
    csr = powerlaw_graph(v, 8, seed=1, self_loops=True)
    feats = make_features(v, d, seed=2)
    specs = init_gnn_params("gcn", [d, 32, 16], seed=3)

    with tempfile.TemporaryDirectory() as td:
        store = GraphStore.create(f"{td}/store", csr, feats, num_partitions=4)
        cfg = AtlasConfig(chunk_bytes=1 << 20, backend=device.type)
        with AtlasSession(store, config=cfg) as session:
            result = session.infer(specs)
            final = result.final

            print("== publishing final layer (compaction + block index)")
            t0 = time.perf_counter()
            published = session.publish(
                final, block_rows=1024, rows_per_file=1 << 16
            )
            print(f"   version v{published.epoch} compacted in "
                  f"{time.perf_counter() - t0:.2f}s")

            reader = session.reader(final.layer, cache_bytes=4 << 20)
            rng = np.random.default_rng(0)
            print("== serving: 2000 Zipfian batches of 64 vertex lookups")
            queries = (rng.zipf(1.1, size=(2000, 64)) - 1) % v
            t0 = time.perf_counter()
            for q in queries:
                reader.lookup(q)
            dt = time.perf_counter() - t0
            if reader.fast_path:  # version fit the budget: zero-copy mmap
                detail = f"{reader.mmap_gathers} mmap gathers, zero-copy"
            else:
                detail = (f"hit rate {reader.cache.hit_rate():.1%}, "
                          f"{reader.blocks_read} disk block reads")
            print(
                f"   {len(queries) / dt:,.0f} queries/s "
                f"({len(queries) * 64 / dt:,.0f} rows/s), {detail}"
            )

            # a point lookup returns the exact engine output row
            vid = int(rng.integers(0, v))
            row = reader.lookup(np.array([vid]))[0]
            print(f"   embedding[{vid}][:4] = {np.round(row[:4], 4)}")

            # versioned re-publish: the open reader keeps its pinned
            # version; a fresh reader sees the new epoch; the stale
            # version is GC'd only once unpinned
            repub = session.publish(final, block_rows=2048)
            assert np.array_equal(reader.lookup(np.array([vid]))[0], row)
            with session.reader(final.layer) as fresh:
                assert fresh.version == repub.epoch
                assert np.array_equal(fresh.lookup(np.array([vid]))[0], row)
            print(f"== re-published as v{repub.epoch}; reader pinned to "
                  f"v{reader.version} kept serving identical rows")
            reader.close()
            gone = session.publish(final).gc_removed
            assert published.epoch in gone
            print(f"== stale versions GC'd on next publish: {list(gone)}")
    print("== OK")


if __name__ == "__main__":
    main()
