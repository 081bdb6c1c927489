"""Elastic-scaling check: train 2 steps on a (4, 2) mesh, checkpoint,
"lose" half the positions, resume on a (2, 2) mesh, and check that the
restored step 3 reproduces the uninterrupted run's, ported from
``repro/launch/elastic_check.py``.

    PYTHONPATH=src python -m repro_torch.launch.elastic_check --ckpt DIR [--devices 8] [--device cpu]

``--devices N`` positions of ``--device`` (default cuda; the name may
repeat, so one card holds the mesh), then N/2 after the loss.  Prints
``LOSS3 8dev=... 4dev=...`` (bar 1e-4) and ``OK``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import elastic_mesh, remesh_factors
from repro_torch.distributed.spmd import make_sharded_train_step, shard_train_state, state_shardings
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import abstract_train_state, init_train_state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config("qwen2-7b")
    opt_cfg = AdamWConfig(lr=1e-3)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks.clone()}  # one draw for both, as the reference's

    # ---- phase 1: N positions, (N/2, 2) ----------------------------------
    n = args.devices
    mesh = elastic_mesh(n, model_parallel=2, devices=args.device)
    state = shard_train_state(init_train_state(cfg, opt_cfg, seed=0, device=dev), mesh)
    step = make_sharded_train_step(cfg, opt_cfg, mesh)
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    mgr = CheckpointManager(args.ckpt, async_save=False)
    mgr.save(2, state)
    state, m = step(state, batch)
    want_loss3 = float(m["loss"])

    # ---- phase 2: "node failure" -> N/2 survivors ---------------------------
    shape, _ = remesh_factors(n // 2, model_parallel=2)
    survivors = elastic_mesh(n // 2, model_parallel=2, devices=args.device)
    print(f"MESHES {mesh.shape} -> {survivors.shape} on {args.device}; losses {losses}")
    abs_state = abstract_train_state(cfg, opt_cfg)
    restored, at = mgr.restore(abs_state, shardings=state_shardings(survivors, abs_state))
    if at != 2 or survivors.shape != shape:
        raise AssertionError((at, survivors.shape, shape))
    _, m = make_sharded_train_step(cfg, opt_cfg, survivors)(restored, batch)
    got_loss3 = float(m["loss"])

    print(f"LOSS3 8dev={want_loss3:.6f} 4dev={got_loss3:.6f}")
    if not abs(want_loss3 - got_loss3) < 1e-4:
        raise AssertionError("elastic resume diverged")
    print("OK")


if __name__ == "__main__":
    main()
