"""Batched LM serving with the PyTorch/CUDA port: prefill a batch of
prompts, then decode tokens.

Uses the serving step functions on a reduced (smoke) config of any
registry arch, with random weights and prompts from seeded
``torch.Generator``s.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen3-14b --tokens 16 [--device cpu]

Runs on the GPU (kernels K3-K6, as the arch uses them) unless
``--device cpu`` is given; without a GPU the default raises
``RuntimeError``.
"""

import argparse
import json
import time

import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention, rglru_scan, rms_norm, ssd_chunk
from repro_torch.models.lm import init_cache, init_params
from repro_torch.train.step import make_serve_prefill, make_serve_step

KERNELS = {"K3": flash_attention, "K4": ssd_chunk, "K5": rms_norm, "K6": rglru_scan}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, seed=0, device=device)
    prefill = make_serve_prefill(cfg)
    step = make_serve_step(cfg)
    before = {k: m.launches.value for k, m in KERNELS.items()}

    b, s = args.batch, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(1)
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device)}
    else:  # audio/vlm: precomputed frame/patch embeddings (modality stub)
        batch = {"embeddings": torch.randn((b, s, cfg.d_model), generator=gen, device=device)}

    print(f"== {cfg.name}: prefill batch={b} len={s} on {device}")
    t0 = time.perf_counter()
    logits, _ = prefill(params, batch)
    _sync(device)
    print(f"   prefill {time.perf_counter() - t0:.2f}s; last-token logits {tuple(logits.shape)}")

    # decode continues from a fresh cache sized prompt+tokens (the tests hold
    # the prefill cache against a decode replay)
    cache = init_cache(cfg, b, s + args.tokens, device)
    generated = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        if cfg.input_mode == "tokens":
            sbatch = {"tokens": tok}
        else:
            sbatch = {"embeddings": torch.randn((b, 1, cfg.d_model), generator=gen, device=device)}
        logits, cache = step(params, cache, sbatch)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        generated.append(tok[:, 0])
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"   decoded {args.tokens} tokens x {b} seqs in {dt:.2f}s "
          f"({args.tokens * b / dt:.1f} tok/s)")
    print("   sample token ids:", torch.stack(generated, 1)[0][:12].tolist())
    launched = {k: m.launches.value - before[k] for k, m in KERNELS.items()}
    print(f"   kernel launches {json.dumps(launched)}")
    print("== OK")


if __name__ == "__main__":
    main()
