"""Serving step builders, ported from ``repro/train/step.py``.

``make_serve_prefill`` and ``make_serve_step`` close over a config and
take the batch dict the JAX package's do.  The train step, the optimizer
and checkpoints come with the training slice (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

from repro_torch.models.lm import LMConfig, decode_step, prefill


def make_serve_prefill(cfg: LMConfig):
    def serve_prefill(params, batch):
        inputs = batch["tokens"] if cfg.input_mode == "tokens" else batch["embeddings"]
        return prefill(params, cfg, inputs)

    return serve_prefill


def make_serve_step(cfg: LMConfig):
    def serve_step(params, cache, batch):
        inputs = batch["tokens"] if cfg.input_mode == "tokens" else batch["embeddings"]
        return decode_step(params, cfg, cache, inputs)

    return serve_step
