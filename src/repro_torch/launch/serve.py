"""Serving launcher: prefill + decode loop for any ported registry arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        [--smoke] [--device cpu] --batch 4 --prompt-len 256 --tokens 16

Runs on the GPU unless ``--device cpu`` is given; weights and prompts are
random, drawn from seeded ``torch.Generator``s on the device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.lm import init_cache, init_params
from repro_torch.train.step import make_serve_prefill, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, seed=0, device=device)
    prefill = make_serve_prefill(cfg)
    step = make_serve_step(cfg)

    b, s = args.batch, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(1)
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device)}
    else:
        batch = {"embeddings": torch.randn((b, s, cfg.d_model), generator=gen, device=device)}
    t0 = time.perf_counter()
    logits, _ = prefill(params, batch)
    _sync(device)
    print(f"[serve] {cfg.name} prefill b={b} s={s}: {time.perf_counter() - t0:.2f}s")

    cache = init_cache(cfg, b, s + args.tokens, device)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        if cfg.input_mode == "tokens":
            sb = {"tokens": tok}
        else:
            sb = {"embeddings": torch.randn((b, 1, cfg.d_model), generator=gen, device=device)}
        logits, cache = step(params, cache, sb)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"[serve] decoded {args.tokens}x{b} tokens in {dt:.2f}s "
          f"({args.tokens * b / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
