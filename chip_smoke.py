#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ATLAS on one GPU and check it.

    python3 chip_smoke.py [--vertices 200000]

Phases, in order; any failure exits non-zero:

1. build   — compile every kernel in src/repro_torch/csrc with nvcc for
             sm_90a (one nvcc per source, in parallel); print nvcc's
             version, the build time, the card and its power limit, and
             the TF32 switches (both off).
2. K1      — chunk aggregation on one chunk at the main path's shapes
             (n=8192 source rows, d=256, ~12 edges per source): kernel vs
             its plain PyTorch version, vs itself (bitwise), vs the host
             oracle chunk_aggregate_numpy, and bitwise on an exact chunk;
             median times of kernel, plain version and torch.sparse.mm.
3. K2      — the graduation transform at [8192,512]@[512,256] relu and
             [8192,512]@[512,172] none, f32 and bf16, vs the plain
             version; median times of kernel, plain and torch.addmm.
4. e2e     — GraphStore.create + AtlasSession.infer of GraphSAGE
             [128,256,256,172] (seed 3) on powerlaw_graph(V, 12) with a
             64 MiB hot store on the card; per-layer LayerMetrics as JSON
             lines and the traced time per span category; both kernels'
             launch counts must grow during infer,
             evictions must occur, and the mean-max-abs error against the
             in-memory dense reference (computed on the card with the
             plain versions) must stay below 1e-5.

Then a {"kernels": [...]} JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.  Bounds use published H100 SXM
peaks: 3.35 TB/s HBM and 67 TFLOP/s f32 on the CUDA cores.

Exits non-zero, printing no result, without a CUDA device or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM f32 without tensor cores, published

K1_RTOL, K1_ATOL = 1e-4, 1e-5  # summation order differs from reduceat
K2_F32_TOL = 1e-5
K2_BF16_TOL = 2e-2
E2E_ERR = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _host_median_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- phases


def phase_build():
    from repro_torch.kernels import _build

    nvcc = _build.nvcc_path()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {built or 'cached'} in {time.perf_counter() - t0:.2f}s "
        f"({', '.join(_build.SIGNATURES)})")
    log(f"[build] card: {smi()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[build] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def _chunk(rng, n, d, edges_per_src, num_vertices, exact):
    m = n * edges_per_src
    src_local = rng.integers(0, n, m).astype(np.int64)
    dst = rng.integers(0, num_vertices, m).astype(np.int64)
    if exact:
        feats = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        w = (2.0 ** -rng.integers(0, 4, m)).astype(np.float32)
    else:
        feats = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
        w = (1.0 / rng.integers(1, 40, m)).astype(np.float32)
    return feats, src_local, dst, w


def _sorted_operands(feats, src_local, dst, w, dev):
    order = np.argsort(dst, kind="stable")
    sdst = dst[order]
    starts = np.nonzero(np.r_[True, sdst[1:] != sdst[:-1]])[0]
    return (
        torch.from_numpy(feats).to(dev),
        torch.from_numpy(src_local[order].astype(np.int32)).to(dev),
        torch.from_numpy(w[order]).to(dev),
        torch.from_numpy(np.r_[starts, len(dst)].astype(np.int32)).to(dev),
    )


def phase_k1(num_vertices: int) -> dict:
    from repro_torch.core.broadcast import chunk_aggregate, chunk_aggregate_numpy
    from repro_torch.kernels.edge_block_spmm import segment_reduce_sorted
    from repro_torch.kernels.ref import segment_reduce_sorted_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    n, d = 8192, 256
    feats, src_local, dst, w = _chunk(rng, n, d, 12, num_vertices, exact=False)
    ops = _sorted_operands(feats, src_local, dst, w, dev)
    got = segment_reduce_sorted(*ops)
    again = segment_reduce_sorted(*ops)
    plain = segment_reduce_sorted_ref(*ops)
    torch.cuda.synchronize()
    max_err = float((got - plain).abs().max())
    torch.testing.assert_close(got, plain, rtol=K1_RTOL, atol=K1_ATOL)
    assert torch.equal(got, again), "K1 is not bitwise deterministic"
    ref_u, ref_p, ref_c = chunk_aggregate_numpy(feats, src_local, dst, w)
    u, p, c = chunk_aggregate("cuda")(feats, src_local, dst, w)
    np.testing.assert_array_equal(u, ref_u)
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_allclose(p, ref_p, rtol=K1_RTOL, atol=K1_ATOL)

    xf, xs, xd, xw = _chunk(rng, n, d, 12, num_vertices, exact=True)
    xops = _sorted_operands(xf, xs, xd, xw, dev)
    xk = segment_reduce_sorted(*xops).cpu().numpy()
    xp = segment_reduce_sorted_ref(*xops).cpu().numpy()
    _, xn, _ = chunk_aggregate_numpy(xf, xs, xd, xw)
    assert np.array_equal(xk, xp) and np.array_equal(xk, xn), "K1 exact chunk"

    num_seg = ops[3].numel() - 1
    m = ops[1].numel()
    csr = torch.sparse_csr_tensor(
        ops[3].long(), ops[1].long(), ops[2], size=(num_seg, n)
    )
    t_kernel = median_ms(lambda: segment_reduce_sorted(*ops))
    t_plain = median_ms(lambda: segment_reduce_sorted_ref(*ops))
    t_lib = median_ms(lambda: torch.sparse.mm(csr, ops[0]))
    lib_err = float((torch.sparse.mm(csr, ops[0]) - plain).abs().max())
    nbytes = sum(t.numel() * t.element_size() for t in ops) + num_seg * d * 4
    b_ms, b_by = bound_ms(nbytes, 2 * m * d)
    log(f"[K1] n={n} d={d} m={m} segments={num_seg}: max|kernel-plain|={max_err:.3g} "
        f"bitwise-repeat=ok numpy-oracle=ok exact-chunk=ok "
        f"kernel={t_kernel:.4f}ms plain={t_plain:.4f}ms sparse.mm={t_lib:.4f}ms "
        f"(max|sparse-plain|={lib_err:.3g}) bound={b_ms:.4f}ms ({b_by}, {nbytes} B)")
    # the whole aggregation stage for this chunk on the host clock: host
    # dictionary + pinned h2d + K1 + synchronous d2h of partial
    agg = chunk_aggregate("cuda")
    t_stage = _host_median_ms(lambda: agg(feats, src_local, dst, w))
    t_d2h = _host_median_ms(
        lambda: torch.from_numpy(np.empty((num_seg, d), np.float32)).copy_(got)
    )
    log(f"[K1] aggregation stage per chunk (host clock): {t_stage:.3f}ms, of which "
        f"d2h of partial ({num_seg * d * 4} B, pageable) {t_d2h:.3f}ms")
    return dict(name="edge_block_spmm", route="cuda",
                source="src/repro_torch/csrc/edge_block_spmm.cu",
                replaces="src/repro/kernels/edge_block_spmm.py:76 (_spmm_kernel)",
                max_abs_err=max_err, ms=t_kernel, kernel_ms=t_kernel,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib)


def phase_k2() -> dict:
    from repro_torch.kernels.fused_graduate import fused_graduate
    from repro_torch.kernels.ref import fused_graduate_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    entry = None
    for n, k, m, act in ((8192, 512, 256, "relu"), (8192, 512, 172, "none")):
        x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
        lim = np.sqrt(6.0 / (k + m))
        w = torch.from_numpy(rng.uniform(-lim, lim, (k, m)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(-0.1, 0.1, m).astype(np.float32)).to(dev)
        for dtype, tol in ((torch.float32, K2_F32_TOL), (torch.bfloat16, K2_BF16_TOL)):
            xa, wa, ba = x.to(dtype), w.to(dtype), b.to(dtype)
            got = fused_graduate(xa, wa, ba, act)
            plain = fused_graduate_ref(xa, wa, ba, act)
            torch.cuda.synchronize()
            err = float((got.float() - plain.float()).abs().max())
            torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
            relu = act == "relu"

            def lib(xa=xa, wa=wa, ba=ba, relu=relu):
                y = torch.addmm(ba, xa, wa)
                return torch.relu(y) if relu else y

            t_kernel = median_ms(lambda: fused_graduate(xa, wa, ba, act))
            t_plain = median_ms(lambda: fused_graduate_ref(xa, wa, ba, act))
            t_lib = median_ms(lib)
            es = xa.element_size()
            nbytes = (n * k + k * m + m + n * m) * es
            b_ms, b_by = bound_ms(nbytes, 2 * n * k * m)
            log(f"[K2] [{n},{k}]@[{k},{m}] {act} {str(dtype)[6:]}: max|kernel-plain|="
                f"{err:.3g} kernel={t_kernel:.4f}ms plain={t_plain:.4f}ms "
                f"addmm={t_lib:.4f}ms bound={b_ms:.4f}ms ({b_by}; f32-core peak) "
                f"-> {2 * n * k * m / t_kernel / 1e9:.1f} TFLOP/s")
            if entry is None:
                entry = dict(name="fused_graduate", route="cuda",
                             source="src/repro_torch/csrc/fused_graduate.cu",
                             replaces="src/repro/kernels/fused_graduate.py:23 (_graduate_kernel)",
                             max_abs_err=err, ms=t_kernel, kernel_ms=t_kernel,
                             plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                             library_ms=t_lib)
    return entry


def phase_e2e(num_vertices: int, workdir: str) -> dict[str, int]:
    from repro_torch.core.atlas import AtlasConfig, spills_to_dense
    from repro_torch.graphs.synth import make_features, powerlaw_graph
    from repro_torch.kernels import edge_block_spmm, fused_graduate
    from repro_torch.models.gnn import dense_reference, init_gnn_params
    from repro_torch.session import AtlasSession
    from repro_torch.storage.layout import GraphStore

    t0 = time.perf_counter()
    csr = powerlaw_graph(num_vertices, 12, seed=1)
    feats = make_features(num_vertices, 128, seed=2)
    store = GraphStore.create(os.path.join(workdir, "store"), csr, feats, order="at")
    log(f"[e2e] store: V={store.num_vertices} E={store.num_edges} order="
        f"{store.ordering_name} built in {time.perf_counter() - t0:.2f}s")
    specs = init_gnn_params("sage", [128, 256, 256, 172], seed=3)
    cfg = AtlasConfig(hot_bytes=64 << 20, backend="cuda", trace=True)

    edge_block_spmm.launches.reset()
    fused_graduate.launches.reset()
    t0 = time.perf_counter()
    with AtlasSession(store, config=cfg, workdir=os.path.join(workdir, "run")) as s:
        result = s.infer(specs)
    wall = time.perf_counter() - t0
    launches = {
        "edge_block_spmm": edge_block_spmm.launches.value,
        "fused_graduate": fused_graduate.launches.value,
    }
    for m in result.metrics:
        log(json.dumps({"layer_metrics": m.as_dict()}))
    log(f"[e2e] infer {wall:.3f}s launches={launches}")
    cats = result.telemetry["trace"]["category_seconds"]
    log("[e2e] traced self-seconds by category (all threads): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(cats.items(), key=lambda kv: -kv[1])}))
    assert all(v > 0 for v in launches.values()), f"kernel not on the path: {launches}"
    evictions = sum(m.evictions for m in result.metrics)
    assert evictions > 0, "the hot store never evicted"

    out = spills_to_dense(result.final.spills, store.num_vertices, result.final.dim)
    assert out.shape == (num_vertices, 172) and np.isfinite(out).all()
    perm = store.old_of_new()
    feats_internal = feats if perm is None else feats[perm]
    t0 = time.perf_counter()
    ref = dense_reference(store.topology(), feats_internal, specs, device="cuda")
    err = float(np.abs(out - ref).max(axis=1).mean())
    log(f"[e2e] mean-max-abs error vs dense reference: {err:.3g} "
        f"(limit {E2E_ERR:g}; mean row max |ref| {np.abs(ref).max(axis=1).mean():.3g}; "
        f"reference {time.perf_counter() - t0:.2f}s)")
    assert err < E2E_ERR, f"e2e error {err} >= {E2E_ERR}"
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vertices", type=int, default=200_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    k1 = phase_k1(args.vertices)
    k2 = phase_k2()
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        launches = phase_e2e(args.vertices, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    k1["launches"] = launches["edge_block_spmm"]
    k2["launches"] = launches["fused_graduate"]
    log(json.dumps({"kernels": [k1, k2]}))
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
