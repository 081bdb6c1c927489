"""Quickstart of the PyTorch/CUDA port: out-of-core full-graph GNN
inference with ATLAS, then serving its output.

Builds a synthetic heavy-tailed graph whose features live on disk, runs
the broadcast-based OOC engine layer by layer under a tight memory
budget via the ``AtlasSession`` lifecycle API (infer → publish →
reader), and checks the result against the in-memory oracle.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the GPU (kernels K1/K2) unless ``--device cpu`` is given;
without a GPU the default raises ``RuntimeError``.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core.atlas import AtlasConfig, spills_to_dense
from repro_torch.core.reorder import (
    make_order,
    relabel_features_chunked,
    relabel_graph,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.synth import make_features, powerlaw_graph
from repro_torch.models.gnn import dense_reference, init_gnn_params
from repro_torch.session import AtlasSession
from repro_torch.storage.layout import GraphStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    v, d = 30_000, 64
    print(f"== building synthetic graph: {v} vertices, ~{12 * v} edges")
    csr = powerlaw_graph(v, 12, seed=1)
    feats = make_features(v, d, seed=2)
    specs = init_gnn_params("sage", [d, 48, 16], seed=3)

    # one-time ATLAS reordering (paper §3.8)
    order = make_order("at", csr)
    csr = relabel_graph(csr, order)
    feats = relabel_features_chunked(feats, order)

    with tempfile.TemporaryDirectory() as td:
        store = GraphStore.create(f"{td}/store", csr, feats, num_partitions=8)
        cfg = AtlasConfig(
            chunk_bytes=1 << 20,  # scaled-down paper chunk
            hot_slots=6_000,  # deliberately tight: forces evict/reload
            eviction="at",  # min-pending-messages policy
            backend=device.type,
        )
        with AtlasSession(store, config=cfg) as session:
            result = session.infer(specs)
            final = result.final
            out = spills_to_dense(final.spills, csr.num_vertices, final.dim)

            # serving: publish the final layer as an immutable versioned
            # servable, then point/batch lookups straight from it — no
            # dense [V, d] materialisation
            published = session.publish(final)
            with session.reader(final.layer, cache_bytes=2 << 20) as reader:
                sample = np.random.default_rng(0).integers(0, v, size=256)
                got = reader.lookup(sample)
                assert np.array_equal(got, out[sample].astype(got.dtype))
                print(
                    f"== served {len(sample)} lookups from version "
                    f"v{published.epoch} ({reader.blocks_read} cold block reads)"
                )
        metrics = result.metrics

    for m in metrics:
        print(
            f"  layer {m.layer}: {m.seconds:.1f}s  read={m.bytes_read >> 20}MiB "
            f"written={m.bytes_written >> 20}MiB  evictions={m.evictions} "
            f"reloads={m.reloads} (reload% {m.reload_pct_mean:.1f})"
        )

    ref = dense_reference(csr, feats, specs, device=device)
    err = np.abs(out - ref).max(axis=1).mean()
    print(f"== mean-max-abs error vs in-memory reference: {err:.2e} "
          f"(paper reports 8e-5)")
    assert err < 1e-4
    print("== OK")


if __name__ == "__main__":
    main()
