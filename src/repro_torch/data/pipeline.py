"""Deterministic synthetic data pipeline, ported from ``repro/data/pipeline.py``.

The global batch for step *s* is a pure function of ``(seed, s)``: its
tokens are drawn with numpy exactly as the reference draws them, so they
are equal to the reference's, and a restart reproduces the stream from any
step.  The reference materializes each host's shard against a
``NamedSharding``; this port has one device per process and puts the
whole batch on ``device``.  A prefetch thread keeps ``depth`` batches in
flight (bounded-queue backpressure, as in the reference).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tokens_for_slice(seed: int, step: int, lo: int, hi: int, seq: int, vocab: int) -> np.ndarray:
    """Rows [lo, hi) of the global batch — pure function of (seed, step)."""
    out = np.empty((hi - lo, seq), np.int32)
    for i, row in enumerate(range(lo, hi)):
        rng = np.random.default_rng((seed, step, row))
        out[i] = rng.integers(0, vocab, size=seq, dtype=np.int32)
    return out


def _embeddings(seed: int, step: int, shape: tuple[int, ...]) -> torch.Tensor:
    """f32 normal embeddings from a ``torch.Generator`` seeded from
    ``(seed, step)`` through numpy's ``SeedSequence``, drawn on the CPU so
    that every device gets the same numbers.  (The reference draws from
    ``jax.random.fold_in(PRNGKey(seed), step)``, which torch cannot
    reproduce: the embeddings differ between the packages, the tokens and
    labels do not.)"""
    state = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    gen = torch.Generator().manual_seed(state)
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def make_global_batch(
    seed: int, step: int, global_batch: int, seq: int, vocab: int,
    device=None, d_model: int | None = None,
) -> dict:
    """``{tokens|embeddings, labels}`` for ``step`` on ``device`` (default
    CUDA): int32 tokens and labels, f32 embeddings."""
    device = resolve_device(device)
    toks = torch.from_numpy(_tokens_for_slice(seed, step, 0, global_batch, seq + 1, vocab))
    batch = {"labels": toks[:, 1:].contiguous().to(device)}
    if d_model is None:
        batch["tokens"] = toks[:, :-1].contiguous().to(device)
    else:  # modality-stub archs: derive embeddings deterministically
        batch["embeddings"] = _embeddings(seed, step, (global_batch, seq, d_model)).to(device)
    return batch


class SyntheticLMStream:
    """Prefetching iterator over deterministic synthetic batches: yields
    ``(step, batch)`` from ``start_step`` on, in order."""

    def __init__(self, seed: int, global_batch: int, seq: int, vocab: int,
                 device=None, d_model: int | None = None,
                 start_step: int = 0, depth: int = 2):
        self._args = (seed, global_batch, seq, vocab, resolve_device(device), d_model)
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True, name="data-prefetch")
        self._thread.start()

    def _fill(self):
        seed, gb, seq, vocab, dev, dm = self._args
        step = self._step
        while not self._stop.is_set():
            batch = make_global_batch(seed, step, gb, seq, vocab, dev, dm)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
