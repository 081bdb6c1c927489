"""Batched serving engine, ported from ``repro/serving/engine.py``: request
queue -> aligned batches -> prefill + decode loop with per-request
termination.

Scheduling policy is *aligned batching*, as in the JAX package: a wave of
up to ``max_batch`` requests is left-padded with token 0 (no padding mask)
to a common prompt length, prefilled together, then the prompts are
replayed through ``decode_step`` to fill the wave's cache, whose logits
replace the prefill's; the wave decodes until every member finishes (EOS
or ``max_tokens``), then the next wave starts.

Runs on ``device`` (default CUDA; ``resolve_device`` raises without it),
where the caller's parameters lie.  Categorical sampling draws from a
``torch.Generator`` on that device seeded by ``seed``.

``stats`` has the JAX engine's keys plus ``prefill_s`` and ``replay_s``,
the seconds each wave spent in its prefill and its prompt replay (host
clock, the device synchronised).  ``on_logits``, if given, is called with
every logits tensor the engine computes, as ``on_logits(stage, logits)``
with ``stage`` one of ``"prefill"``, ``"replay"`` and ``"decode"``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import LMConfig, init_cache
from repro_torch.train.step import make_serve_prefill, make_serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [S] int32 tokens, or [S, d_model] embeddings
    max_tokens: int = 32
    eos_id: int | None = None
    # filled by the engine:
    output_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: LMConfig, params, max_batch: int = 8,
                 greedy: bool = True, seed: int = 0, device="cuda", on_logits=None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.greedy = greedy
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = make_serve_prefill(cfg)
        self._step = make_serve_step(cfg)
        self._on_logits = on_logits or (lambda stage, logits: None)
        self._queue: deque[Request] = deque()
        self.stats = {"requests": 0, "tokens": 0, "waves": 0, "decode_s": 0.0,
                      "prefill_s": [], "replay_s": []}

    def submit(self, req: Request) -> None:
        self._queue.append(req)
        self.stats["requests"] += 1

    # ------------------------------------------------------------ wave
    def _pad_prompts(self, wave: list[Request]):
        s = max(len(r.prompt) for r in wave)
        if self.cfg.input_mode == "tokens":
            buf = np.zeros((len(wave), s), np.int32)
        else:
            buf = np.zeros((len(wave), s, self.cfg.d_model), np.float32)
        for i, r in enumerate(wave):
            buf[i, s - len(r.prompt):] = r.prompt  # left-pad: ends align
        return torch.from_numpy(buf).to(self.device), s

    def _batch(self, inputs: torch.Tensor) -> dict:
        key = "tokens" if self.cfg.input_mode == "tokens" else "embeddings"
        return {key: inputs}

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.to(torch.float32), -1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def run_wave(self) -> list[Request]:
        """Serve one wave; returns the completed requests."""
        wave = [self._queue.popleft()
                for _ in range(min(self.max_batch, len(self._queue)))]
        if not wave:
            return []
        self.stats["waves"] += 1
        prompts, s = self._pad_prompts(wave)
        t0 = self._clock()
        logits, _ = self._prefill(self.params, self._batch(prompts))
        t1 = self._clock()
        self.stats["prefill_s"].append(t1 - t0)
        self._on_logits("prefill", logits)

        max_new = max(r.max_tokens for r in wave)
        cache = init_cache(self.cfg, len(wave), s + max_new, self.device)
        # replay prompts through decode to fill the wave cache (aligned
        # batching keeps a single scalar position for the whole wave)
        for t in range(s):
            logits, cache = self._step(self.params, cache, self._batch(prompts[:, t:t + 1]))
            self._on_logits("replay", logits)
        self.stats["replay_s"].append(self._clock() - t1)

        tok = self._sample(logits).to(torch.int32)
        t0 = time.perf_counter()
        alive = np.ones(len(wave), bool)
        host = tok.cpu().numpy()
        for i, r in enumerate(wave):
            t_i = int(host[i])
            r.output_tokens.append(t_i)
            if (r.eos_id is not None and t_i == r.eos_id) or r.max_tokens <= 1:
                alive[i] = False
        for _ in range(max_new - 1):
            if not alive.any():
                break
            if self.cfg.input_mode == "tokens":
                step_in = tok[:, None]
            else:  # modality stubs: feed the token's embedding row
                emb = self.params["lm_head"].T[tok.long()].to(torch.float32)
                step_in = emb[:, None]
            logits, cache = self._step(self.params, cache, self._batch(step_in))
            self._on_logits("decode", logits)
            tok = self._sample(logits).to(torch.int32)
            host = tok.cpu().numpy()
            for i, r in enumerate(wave):
                if not alive[i]:
                    continue
                t_i = int(host[i])
                r.output_tokens.append(t_i)
                if (r.eos_id is not None and t_i == r.eos_id) or \
                        len(r.output_tokens) >= r.max_tokens:
                    alive[i] = False
            self.stats["tokens"] += int(alive.sum()) + 1
            if not alive.any():
                break
        self.stats["decode_s"] += time.perf_counter() - t0
        for r in wave:
            r.done = True
        return wave

    def run(self) -> list[Request]:
        done = []
        while self._queue:
            done.extend(self.run_wave())
        return done
