"""End-to-end training script of the PyTorch/CUDA port: a ~100M-parameter
dense LM on synthetic data.

Shows the port's training substrate (config, AdamW with its LR schedule,
checkpoint and restore, deterministic per-step data) on one device.  A
second run on the same ``--ckpt`` resumes from its latest checkpoint.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]

Runs on the GPU (kernels K3 and K5, forward and backward) unless
``--device cpu`` is given; without a GPU the default raises
``RuntimeError``.
"""

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import LMConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, tree_leaves
from repro_torch.train.step import init_train_state, make_train_step


def model_100m() -> LMConfig:
    # ~100M params: 12L x d768 (qwen3-family block structure)
    return LMConfig(
        name="qwen3-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=16384, qk_norm=True, mlp_kind="swiglu",
        dtype_name="float32", attn_block_kv=512,
    ).validate()


def synthetic_batch(seed: int, batch: int, seq: int, vocab: int, device) -> dict:
    """Deterministic 'language' for one step, drawn from a
    ``torch.Generator`` seeded with ``seed``: token t of a row is
    (x0 * 3^t + 7t) % vocab with 5 % noise, learnable structure so the
    loss visibly drops."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = torch.randint(0, vocab, (batch, 1), generator=gen, device=device, dtype=torch.int64)
    steps = torch.arange(seq, device=device)
    pow3 = torch.tensor([pow(3, t, vocab) for t in range(seq)], device=device)
    toks = (x0 * pow3 + 7 * steps) % vocab
    noise = torch.rand(toks.shape, generator=gen, device=device) < 0.05
    rand = torch.randint(0, vocab, toks.shape, generator=gen, device=device, dtype=torch.int64)
    toks = torch.where(noise, rand, toks).to(torch.int32)
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_100m()
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    state = init_train_state(cfg, opt_cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"== {cfg.name}: {n_params / 1e6:.1f}M params on {device}")

    step_fn = make_train_step(cfg, opt_cfg)
    mgr = CheckpointManager(args.ckpt, keep=2)
    start = mgr.latest_step() or 0
    if start:
        state, start = mgr.restore(state, device=device)
        print(f"== resumed from step {start}")

    t0 = time.time()
    for s in range(start, args.steps):
        batch = synthetic_batch(1000 + s, args.batch, args.seq + 1, cfg.vocab_size, device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        assert math.isfinite(loss), f"step {s + 1}: loss {loss}"
        if (s + 1) % 10 == 0 or s == start:
            print(f"step {s + 1:4d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{(s + 1 - start) * args.batch * args.seq / (time.time() - t0):.0f} tok/s")
        if (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, state)
    mgr.wait()
    print(f"== done: {args.steps} steps in {time.time() - t0:.0f}s; "
          f"checkpoints in {args.ckpt}")
    print("== OK")


if __name__ == "__main__":
    main()
