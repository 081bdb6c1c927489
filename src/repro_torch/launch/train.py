"""Training launcher: ``--arch <id>`` from the registry, on one device or
sharded over an elastic mesh, synthetic data, checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --smoke \
        [--device cpu] [--devices 4 --model-parallel 2] --steps 20 --batch 4 --seq 64 \
        [--ckpt DIR]

Runs on the GPU unless ``--device cpu`` is given.  ``--devices N``
positions of ``--device`` (the name may repeat, so one card holds the
mesh) form ``elastic_mesh(N, --model-parallel)``, as the reference's
launcher builds one over ``jax.devices()``; on more than one position the
state is sharded and ``distributed.spmd``'s sharded step trains it, on
one the one-device ``make_train_step`` does.  Batches come from
``data.pipeline.make_global_batch(seed=0, step)`` (numpy tokens; the
reference's launcher draws them with ``jax.random.randint`` instead, so
the two launchers see different data).  Every family trains: dense,
audio, vlm, moe, ssm (K4's backward kernel on the card) and hybrid
(recurrentgemma-9b: K6's and the windowed K3's backward kernels on the
card); the sharded step splits heads and MLP columns over ``model`` for
the attention-and-MLP families and runs the others whole on each data
shard.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data.pipeline import make_global_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import elastic_mesh
from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, tree_leaves
from repro_torch.train.step import init_train_state, make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--model-parallel", type=int, default=None)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = elastic_mesh(args.devices, model_parallel=args.model_parallel, devices=args.device)
    if mesh.size == 1:
        print(f"[train] {cfg.name} on {device}")
    else:
        print(f"[train] {cfg.name} on mesh {dict(zip(mesh.axis_names, mesh.shape))} over "
              f"{device}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    state = init_train_state(cfg, opt_cfg, seed=0, device=device)
    n = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"[train] {n / 1e6:.1f}M params")

    d_model = None if cfg.input_mode == "tokens" else cfg.d_model
    if mesh.size == 1:
        step_fn = make_train_step(cfg, opt_cfg)
    else:
        state = shard_train_state(state, mesh)
        step_fn = make_sharded_train_step(cfg, opt_cfg, mesh)
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    t0 = time.time()
    for s in range(args.steps):
        batch = make_global_batch(0, s, args.batch, args.seq, cfg.vocab_size, device, d_model)
        state, m = step_fn(state, batch)
        if (s + 1) % 10 == 0 or s == 0:
            print(f"[train] step {s + 1:4d} loss {float(m['loss']):.6f} "
                  f"gnorm {float(m['grad_norm']):.6f}")
        if mgr and (s + 1) % 50 == 0:
            mgr.save(s + 1, state)
    if mgr:
        mgr.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[train] {args.steps} steps in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
