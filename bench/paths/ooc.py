"""ATLAS's own path: out-of-core inference through ``AtlasSession.infer``.

Set-up: the traffic's graph (host, from the seed), features and weights
(device, from the seed; the features copied to the host for the store),
``GraphStore.create`` under the run's temporary directory in the
traffic's ``order``, an ``AtlasSession`` on ``AtlasConfig(hot_bytes=...,
backend="cuda")``, and ``warmup_layers`` layers of one ``infer`` (the
kernels load, the pinned buffers and threads start) without a whole pass.

Window: ``infer`` passes back to back, until the first pass end past
``--seconds``; every pass in it is whole.  The process's resident set is
sampled every 10 ms over the first pass alone, a fixed amount of work
whatever the host's speed and ``--seconds`` (the set grows from pass to
pass; each pass end's reading is logged).  The last pass's final layer's
spills, read back in the caller's ids through the store's permutation,
are compared with the f64 reference once the window has closed.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from bench import inputs
from bench.devtrace import DeviceTrace, span
from bench.frozen.rss import read_rss_bytes
from bench.harness import device_info, log
from bench.reference import gnn as reference
from bench.window import RssSampler, clock, whole_passes


def _pinned_peak() -> int | None:
    """The caching host allocator's peak of pinned bytes, where this
    torch reports it."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        return None
    stats = torch.cuda.host_memory_stats()
    for key in ("allocated_bytes.all.peak", "allocated_bytes.peak"):
        if key in stats:
            return int(stats[key])
    return None


def run(spec) -> dict:
    t_enter = clock()
    from repro_torch.core.atlas import AtlasConfig, AtlasEngine, spills_to_dense
    from repro_torch.graphs.csr import CSRGraph
    from repro_torch.models.gnn import GNNLayerSpec
    from repro_torch.session import AtlasSession
    from repro_torch.storage.layout import GraphStore

    t_imports = clock() - t_enter

    class LayerSpan(AtlasEngine):
        """The program's engine, each layer in a host range of the trace."""

        def run_layer(self, *args, **kwargs):
            with span("bench.layer"):
                return super().run_layer(*args, **kwargs)

    dev = torch.device(spec.device)
    cuda = dev.type == "cuda"
    config, traffic = spec.config, spec.traffic
    kind, widths = config["model"], config["widths"]
    tmp = tempfile.mkdtemp(prefix="bench-ooc-")
    sampler = RssSampler()
    try:
        t = clock()
        g, cached = inputs.make_graph(traffic["graph"], spec.cache_dir)
        x0, layers = inputs.make_tensors(config, g.num_vertices, spec.seed, dev)
        feats = x0.cpu().numpy()
        t_inputs = clock() - t
        t = clock()
        store = GraphStore.create(os.path.join(tmp, "store"),
                                  CSRGraph(indptr=g.indptr, indices=g.indices), feats,
                                  order=traffic["order"])
        t_store = clock() - t
        del feats
        specs = [GNNLayerSpec(kind=kind, in_dim=widths[k], out_dim=widths[k + 1],
                              activation=k < len(layers) - 1, params={"w": w, "b": b})
                 for k, (w, b) in enumerate(layers)]
        cfg = AtlasConfig(hot_bytes=int(traffic["hot_bytes"]),
                          backend="cuda" if cuda else "cpu", trace=spec.trace)
        engine = LayerSpan(cfg)
        ends: list[float] = []
        rss = None  # the sampler's peak over the first pass
        layer_metrics = []  # per pass, per layer: LayerMetrics as dicts
        with AtlasSession(store, engine=engine, workdir=os.path.join(tmp, "run")) as session:
            t = clock()
            warm = session.infer(specs[: int(traffic["warmup_layers"])])
            t_warm = clock() - t
            before = (warm.telemetry or {}).get("trace", {}).get("category_seconds", {})
            if cuda:
                torch.cuda.synchronize()
                setup_peak = torch.cuda.max_memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
                    torch.cuda.reset_peak_host_memory_stats()
                else:
                    log("[ooc] this torch cannot reset the pinned peak: it is since set-up")
            else:
                setup_peak = 0

            with DeviceTrace(spec.trace and cuda) as trace:
                start = clock()
                sampler.start()
                with trace.window():
                    while not ends or ends[-1] - start < spec.seconds:
                        with span("bench.pass"):
                            last = session.infer(specs)
                        ends.append(clock())
                        if rss is None:
                            rss = sampler.stop()
                        layer_metrics.append([m.as_dict() for m in last.metrics])
                        log(f"[ooc] pass {len(ends)} ends {ends[-1] - start:.4f} s into the "
                            f"window: RSS {read_rss_bytes()} B")
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            pinned = _pinned_peak() if cuda else None
            window_s, passes = whole_passes(start, ends)
            after = (last.telemetry or {}).get("trace", {}).get("category_seconds", {})
            final = last.final
            out = spills_to_dense(final.spills, store.num_vertices, final.dim)
            new_of_old = store.new_of_old()
            out = out if new_of_old is None else out[np.asarray(new_of_old)]
        written = sum(m["bytes_written"] + m["cold_bytes_written"]
                      for ms in layer_metrics for m in ms)
        log(f"[ooc] {spec.cell}: V={g.num_vertices} E={g.num_edges}; set-up: harness "
            f"{t_enter - spec.t0:.3f} s, imports {t_imports:.3f} s, inputs "
            f"{t_inputs:.3f} s (graph {'cached' if cached else 'generated'}), store "
            f"{t_store:.3f} s, warm-up {t_warm:.3f} s; window {window_s:.4f} s, {passes} "
            f"passes; peak {peak} B (set-up {setup_peak} B); over the first pass RSS "
            f"{rss} B ({sampler.samples} samples); pinned {pinned} B; the passes wrote {written} B "
            f"of spills and cold rows")
        t = clock()
        src, dst = inputs.edge_tensors(g, dev)
        ref = reference.forward(kind, src, dst, g.num_vertices, x0, layers, "f64")
        checks = {"row_err.last": reference.row_error(torch.from_numpy(out), ref)}
        log(f"[ooc] reference (f64) and comparison {clock() - t:.3f} s")
    finally:
        sampler.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    n = len(layer_metrics)
    return {
        "ctx": {
            "setup_s": start - spec.t0,
            "window": {"seconds": window_s, "passes": passes},
            "peak_device_bytes": peak,
            "peak_host_bytes": rss,
            "graph": {"num_vertices": g.num_vertices, "num_edges": g.num_edges},
            "config": config,
            "trace": trace.summary,
            "ooc": {
                "passes": n,
                "layer_metrics": layer_metrics,
                "category_seconds": {k: (v - before.get(k, 0.0)) / n for k, v in after.items()},
                "pinned_peak_bytes": pinned,
            },
        },
        "checks": checks,
        "attempted": n,
        "device": device_info(dev, max(setup_peak, peak)),
    }
