"""Gradient-compression check: the int8 error-feedback sum against the
exact sum over the positions of a data axis, ported from
``repro/launch/compression_check.py``.

    PYTHONPATH=src python -m repro_torch.launch.compression_check --devices 4 [--device cpu]

``--devices N`` positions of ``--device`` (default cuda; the name may
repeat, so one card holds them all).  Prints ``ONESHOT_RELERR`` (bar
0.05), ``FEEDBACK_RELERR`` after 32 rounds (bar 5e-3) and ``OK``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.sharding import position_devices
from repro_torch.launch.mesh import make_mesh


def _relerr(got: list, want: list) -> float:
    return max(float((g - w).abs().max() / (w.abs().max() + 1e-9)) for g, w in zip(got, want))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    n = args.devices
    devices = position_devices(make_mesh((n,), ("data",), args.device))
    rng = np.random.default_rng(0)
    host = rng.normal(size=(n, 4096)).astype(np.float32)
    grads = [torch.from_numpy(host[p]).to(d) for p, d in enumerate(devices)]
    errs = [torch.zeros(4096, dtype=torch.float32, device=d) for d in devices]

    exact = sum(g.to(devices[0]) for g in grads)
    want = [exact.to(d) for d in devices]
    got, _ = compressed_psum(grads, errs)
    rel = _relerr(got, want)
    print(f"ONESHOT_RELERR {rel:.4e}")
    if not rel < 0.05:
        raise AssertionError("int8 psum too lossy")

    # error feedback: the mean over rounds converges to the exact sum
    rounds = 32
    total = [torch.zeros_like(w) for w in want]
    err = errs
    for _ in range(rounds):
        out, err = compressed_psum(grads, err)
        total = [t + o for t, o in zip(total, out)]
    mean_rel = _relerr([t / rounds for t in total], want)
    print(f"FEEDBACK_RELERR {mean_rel:.4e}")
    if not mean_rel < 5e-3:
        raise AssertionError("error feedback did not converge")
    print("OK")


if __name__ == "__main__":
    main()
