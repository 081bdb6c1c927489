"""Pipeline-parallel check: the GPipe forward and its gradients against
the sequential oracle on an n-stage mesh, ported from
``repro/launch/pipeline_check.py``.

    PYTHONPATH=src python -m repro_torch.launch.pipeline_check --devices 4 --stages 4 [--device cpu]

The stages are ``--stages`` of the ``--devices`` positions of
``--device`` (default cuda; the name may repeat).  Prints ``FWD_ERR``
(bar 1e-5), ``GRAD_RELERR`` (bar 1e-4) and ``OK``; f32 throughout.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.pipeline import make_pipeline_forward, sequential_forward
from repro_torch.launch.mesh import make_mesh


def layer_fn(lp, h):
    return h + torch.tanh(h @ lp["w1"]) @ lp["w2"]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.stages > args.devices:
        raise ValueError(f"{args.stages} stages need as many positions, have {args.devices}")

    dev = resolve_device(args.device)
    mesh = make_mesh((args.stages,), ("stage",), args.device)
    L, M, MB, D, F = 8, 6, 4, 16, 32
    rng = np.random.default_rng(0)
    params = {
        "w1": torch.from_numpy((rng.normal(size=(L, D, F)) * 0.3).astype(np.float32)).to(dev),
        "w2": torch.from_numpy((rng.normal(size=(L, F, D)) * 0.3).astype(np.float32)).to(dev),
    }
    x = torch.from_numpy(rng.normal(size=(M, MB, D)).astype(np.float32)).to(dev)

    pipe = make_pipeline_forward(mesh, "stage", layer_fn)
    want = sequential_forward(params, x, layer_fn)
    got = pipe(params, x)
    err = float((got - want).abs().max())
    print(f"FWD_ERR {err:.3e}")
    if not err < 1e-5:
        raise AssertionError("pipeline forward mismatch")

    def grads(fn):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = torch.sum(fn(leaves) ** 2)
        return torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])

    gp = grads(lambda p: pipe(p, x))
    gs = grads(lambda p: sequential_forward(p, x, layer_fn))
    gerr = max(float((a - b).abs().max() / (b.abs().max() + 1e-9)) for a, b in zip(gp, gs))
    print(f"GRAD_RELERR {gerr:.3e}")
    if not gerr < 1e-4:
        raise AssertionError("pipeline grad mismatch")
    print("OK")


if __name__ == "__main__":
    main()
