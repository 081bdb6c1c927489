"""GAT with the whole graph in device memory: the program's GAT layer
steps on a mesh (``hbm.py``'s path for ``kind="gat"``).

Set-up: the traffic's graph (host, from the traffic's seed, cached in the
checkout after its first run), features and weights (device, from the
seed, ``bench/inputs_gat.py``), the program's ``build_combined_plan(...,
kind="gat")`` and ``make_combined_layer_step(..., kind="gat")`` on
``make_mesh(traffic["mesh"])`` (one step for the hidden layers, one for
the output layer), the features placed by ``shard_features``, and
``warmup_passes`` whole passes (the steps' first calls place the plan's
indices and slab tables on the card).

Window: full-graph passes back to back, each ending in
``torch.cuda.synchronize()``, until the first pass end past
``--seconds``.  With ``--trace 1`` the steps get an enabled tracer: each
phase of a layer is a span (a ``atlas.gat:<name>`` range in the device
trace), and CUDA events around the attention (score .. normalize) give
``att_s``.  The first and the last pass's final embeddings stay on the
card; once the window has closed and the program's state is freed, each
is compared with the f64 reference (``bench/reference/gat.py``), row by
row.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench import inputs, inputs_gat
from bench.devtrace import DeviceTrace, span
from bench.harness import device_info, log
from bench.reference import gat as reference
from bench.reference.gnn import row_error
from bench.window import RssSampler, clock, whole_passes


def _assemble(shards) -> torch.Tensor:
    """``[S][M]`` output shards as one ``[S·v_local, F]`` tensor, on the card."""
    return torch.cat([torch.cat(list(row), dim=1) for row in shards])


def run(spec) -> dict:
    t_enter = clock()
    from repro_torch.dist import mesh as dm
    from repro_torch.graphs.csr import CSRGraph
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.trace import NULL_TRACER, Tracer

    if not hasattr(dm, "GATLayerStep"):  # a program without GAT fails here, before set-up
        raise RuntimeError("the program under test has no GAT layer step "
                           "(repro_torch.dist.mesh.GATLayerStep)")
    t_imports = clock() - t_enter

    dev = torch.device(spec.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    config, traffic = spec.config, spec.traffic
    t = clock()
    g, cached = inputs.make_graph(traffic["graph"], spec.cache_dir)
    t_graph = clock() - t
    t = clock()
    x0, layers = inputs_gat.make_tensors(config, g.num_vertices, spec.seed, dev)
    sync()
    t_tensors = clock() - t
    t = clock()
    shape = tuple(int(n) for n in traffic["mesh"])
    plan = dm.build_combined_plan(CSRGraph(indptr=g.indptr, indices=g.indices), shape[0],
                                  kind="gat")
    t_plan = clock() - t
    mesh = make_mesh(shape, ("data", "model"), devices=[spec.device] * math.prod(shape))
    v, vp = g.num_vertices, plan.num_shards * plan.v_local
    x = x0 if vp == v else torch.cat([x0, x0.new_zeros(vp - v, x0.shape[1])])
    feats = dm.shard_features(mesh, x)
    tracer = Tracer() if spec.trace else NULL_TRACER
    steps, calls = {}, []
    for k, p in enumerate(layers):
        concat = bool(config["concat"][k])
        if concat not in steps:
            steps[concat] = dm.make_combined_layer_step(
                mesh, kind="gat", concat=concat, activation=concat, tracer=tracer)
        calls.append((steps[concat], (p["w"], p["a_src"], p["a_dst"], p["b"], p.get("w_skip"))))
    step_host = [0.0, 0]

    def one_pass():
        h = feats
        with span("bench.pass"):
            for k, (step, args) in enumerate(calls):
                with span(f"bench.layer.{k}"):
                    t_call = clock()
                    h = step(h, plan, *args)
                    step_host[0] += clock() - t_call
                    step_host[1] += 1
            with span("bench.sync"):
                sync()
        return h

    t = clock()
    for _ in range(int(traffic["warmup_passes"])):
        one_pass()
    for step in steps.values():
        step.attention_seconds()  # the warm-up's events, dropped
    t_warm = clock() - t
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    step_host[:] = [0.0, 0]
    ends, first, out = [], None, None
    sampler = RssSampler()
    with DeviceTrace(spec.trace and cuda) as trace:
        start = clock()
        sampler.start()
        try:
            with trace.window():
                while True:
                    out = one_pass()
                    ends.append(clock())
                    if first is None:
                        first = out
                    if ends[-1] - start >= spec.seconds:
                        break
        finally:
            rss = sampler.stop()
    window_s, passes = whole_passes(start, ends)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    att = sum(step.attention_seconds() for step in steps.values())
    log(f"[hbm_gat] {spec.cell}: V={v} E={g.num_edges} max in-degree "
        f"{int(np.bincount(g.indices, minlength=v).max())}; heads {config['heads']} of "
        f"{config['head_dims']}; mesh {shape}, bucket {plan.bucket}, slots {plan.slots}; set-up: "
        f"harness {t_enter - spec.t0:.3f} s, imports {t_imports:.3f} s, graph {t_graph:.3f} s "
        f"({'cached' if cached else 'generated'}), tensors {t_tensors:.3f} s, plan "
        f"{t_plan:.3f} s, warm-up {t_warm:.3f} s; window {window_s:.4f} s, {passes} passes; "
        f"attention (events) {att:.4f} s; peak {peak} B (set-up {setup_peak} B), RSS {rss} B")

    outputs = {"first": _assemble(first)[:v], "last": _assemble(out)[:v]}
    del first, out, feats, x, steps, calls, plan
    if cuda:
        torch.cuda.empty_cache()
    t = clock()
    src, dst = inputs.edge_tensors(g, dev)
    ref = reference.forward(config, src, dst, v, x0, layers, "f64")
    checks = {f"row_err.{k}": row_error(o, ref) for k, o in outputs.items()}
    log(f"[hbm_gat] reference (f64) and comparison {clock() - t:.3f} s")
    ctx = {
        "setup_s": start - spec.t0,
        "window": {"seconds": window_s, "passes": passes},
        "peak_device_bytes": peak,
        "peak_host_bytes": rss,
        "graph": {"num_vertices": v, "num_edges": g.num_edges},
        "config": config,
        "trace": trace.summary,
        "step_host_ms": step_host[0] / max(step_host[1], 1) * 1e3,
    }
    if spec.trace and cuda:
        ctx["att_s"] = att / passes
    return {"ctx": ctx, "checks": checks, "attempted": passes,
            "device": device_info(dev, max(setup_peak, peak))}
