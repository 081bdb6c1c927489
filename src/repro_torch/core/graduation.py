"""Graduation processor (paper §3.6).

Vertices whose pending count reaches zero are "graduated": their finalized
aggregate rows move into a graduation buffer (freeing hot-store slots
immediately).  Full buffers are handed to a dedicated offload thread which
runs the layer's dense transform (the accelerator step: W·x + b + σ) and
enqueues results to the writer.  ``LayerTransform`` is that transform on
a device: on CUDA the offload thread copies each buffer h2d through a
reused pinned buffer on its own stream, runs kernel K2 there, and copies
the result back into numpy for the writer.  Double buffering keeps the main thread
filling one buffer while the other is in flight.

Two buffering strategies, selected by ``impl``:

* ``"array"`` (default) — fixed-cost-per-batch ring buffers: a small pool
  of preallocated ``(ids, rows)`` buffer pairs.  ``add``/``add_gather``
  copy straight into the active buffer; a full buffer is handed to the
  offload thread **by reference** (only its pool index crosses the
  queue), and the thread recycles it through a free-list once the
  transform output is on its way to the writer.  No per-add list appends,
  no per-emit ``np.concatenate`` over the backlog.
* ``"python"`` — the seed's list-append + concatenate implementation,
  kept as the correctness oracle and as the baseline the layer-tail
  benchmark measures against (``bench_delivery.py --mode engine``).

Both impls share the offload-thread failure semantics of
``repro.util.offload.OffloadWorker``: a sink/transform error is sticky,
``add``/``flush``/``close`` re-raise it (check-then-mutate, so buffered
state is never corrupted by the raise), and producers can never deadlock
on a dead consumer.

Downstream, the sink (``EmbeddingWriter.write``) may itself front the
write-back I/O scheduler (``repro.storage.io_scheduler``): a spill
failure on the scheduler's thread re-raises out of the writer's enqueue
as that worker's sticky error, is captured *here* as this stage's
sticky error, and so surfaces to the engine loop through the same
``add``/``flush``/``close`` protocol — three chained offload stages,
one failure contract, and the group-commit barrier at the end of the
layer catches anything still in flight.
"""

from __future__ import annotations

import queue
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import PinnedStaging
from repro_torch.models.gnn import GNNLayerSpec, layer_update
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.util.offload import OffloadWorker


class LayerTransform:
    """One layer's dense transform as the graduation stage calls it:
    finalized numpy rows ``[n, hot_width]`` in, numpy ``[n, out_dim]``
    f32 out, computed on ``device`` by ``layer_update``.  The layer's
    weights are uploaded once, here, not once per batch."""

    def __init__(self, spec: GNNLayerSpec, device: torch.device):
        self.device = device
        self.spec = spec.to(device)
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
            self._pinned = PinnedStaging()

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(rows, np.float32)
        if self.device.type == "cpu":
            return layer_update(self.spec, torch.from_numpy(rows)).numpy()
        host = self._pinned.fill(rows=rows)
        with torch.cuda.stream(self._stream):
            x = host["rows"].to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            self._pinned.copied(copied)
            y = layer_update(self.spec, x)
            out = np.empty(tuple(y.shape), dtype=np.float32)
            # synchronous on this stream: out is complete on return
            torch.from_numpy(out).copy_(y)
        return out


def make_graduation(impl: str, **kwargs) -> "GraduationProcessor":
    if impl == "array":
        return GraduationProcessor(**kwargs)
    if impl == "python":
        return PythonGraduationProcessor(**kwargs)
    raise ValueError(f"unknown graduation impl {impl!r} (want 'array'|'python')")


class GraduationProcessor:
    """Array-native graduation stage: preallocated ring buffers handed to
    the offload thread by reference."""

    def __init__(
        self,
        transform: Callable[[np.ndarray], np.ndarray],
        sink: Callable[[np.ndarray, np.ndarray], None],
        dim: int,
        dtype,
        buffer_rows: int = 8192,
        queue_depth: int = 20,
        threaded: bool = True,
        num_buffers: int = 2,
        tracer=None,
    ):
        self.transform = transform
        self.sink = sink
        self.dim = dim
        self.dtype = np.dtype(dtype)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.buffer_rows = max(1, buffer_rows)
        self.graduated = 0
        self.offload_batches = 0
        self._closed = False
        # timing split for the layer-tail benchmark: _buffer_s accrues on
        # the caller thread, _proc_s on the offload thread; transform and
        # sink are tracked separately so tail bookkeeping can be isolated
        self._buffer_s = 0.0
        self._proc_s = 0.0
        self._transform_s = 0.0
        self._sink_s = 0.0

        self._free: queue.Queue = queue.Queue()
        self._active = 0
        self._fill = 0
        self._init_buffers(max(2, num_buffers) if threaded else 1)
        self._worker: OffloadWorker | None = None
        if threaded:
            self._worker = OffloadWorker(
                self._process,
                name="atlas-graduate",
                queue_depth=queue_depth,
                on_drop=self._recycle_dropped,
            )

    def _init_buffers(self, n_buf: int) -> None:
        # uint64 id buffers: the spill writer's native id dtype, so the
        # emitted ids flow into EmbeddingWriter.write without a cast copy
        self._buf_ids = [
            np.empty(self.buffer_rows, dtype=np.uint64) for _ in range(n_buf)
        ]
        self._buf_rows = [
            np.empty((self.buffer_rows, self.dim), dtype=self.dtype)
            for _ in range(n_buf)
        ]
        for i in range(1, n_buf):
            self._free.put(i)

    def _recycle_dropped(self, item) -> None:
        """Return a dropped in-flight buffer (by pool index) to the
        free-list so a failed offload thread cannot strand the producer."""
        self._free.put(item[0])

    # -------------------------------------------------------------- feed
    def _raise_pending(self) -> None:
        if self._worker is not None:
            self._worker.raise_pending()

    def add(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Buffer graduated ``(ids, rows)``; emits full buffers downstream.

        Checks for a deferred offload error *before* touching any state,
        so a raise never leaves half-buffered rows behind."""
        n = len(ids)
        if n == 0:
            return
        self._raise_pending()
        with self.tracer.span("graduate_buffer", "tail"):
            t0 = time.perf_counter()
            ids = np.asarray(ids)
            rows = np.asarray(rows)
            pos = 0
            while pos < n:
                take = min(self.buffer_rows - self._fill, n - pos)
                f = self._fill
                self._buf_ids[self._active][f : f + take] = ids[pos : pos + take]
                self._buf_rows[self._active][f : f + take] = rows[pos : pos + take]
                self._fill += take
                pos += take
                if self._fill == self.buffer_rows:
                    self._buffer_s += time.perf_counter() - t0
                    self._emit()
                    t0 = time.perf_counter()
            self.graduated += n
            self._buffer_s += time.perf_counter() - t0

    def add_gather(
        self, ids: np.ndarray, source: np.ndarray, rows_index: np.ndarray
    ) -> None:
        """Like ``add(ids, source[rows_index])`` but gathers straight into
        the ring buffer — no intermediate row copy.  This is the hand-off
        ``MemoryManager.release_to`` uses to move finalized hot-store rows
        into the graduation buffer in one fancy-indexed copy."""
        n = len(ids)
        if n == 0:
            return
        self._raise_pending()
        with self.tracer.span("graduate_buffer", "tail"):
            t0 = time.perf_counter()
            ids = np.asarray(ids)
            rows_index = np.asarray(rows_index)
            pos = 0
            while pos < n:
                take = min(self.buffer_rows - self._fill, n - pos)
                f = self._fill
                self._buf_ids[self._active][f : f + take] = ids[pos : pos + take]
                np.take(
                    source,
                    rows_index[pos : pos + take],
                    axis=0,
                    out=self._buf_rows[self._active][f : f + take],
                    mode="clip",  # in-range by construction; avoids staging
                )
                self._fill += take
                pos += take
                if self._fill == self.buffer_rows:
                    self._buffer_s += time.perf_counter() - t0
                    self._emit()
                    t0 = time.perf_counter()
            self.graduated += n
            self._buffer_s += time.perf_counter() - t0

    # -------------------------------------------------------------- emit
    def _emit(self) -> None:
        """Hand the active buffer downstream and acquire a fresh one."""
        if not self._fill:
            return
        self._raise_pending()
        item = (self._active, self._fill)
        self.offload_batches += 1
        self._fill = 0
        if self._worker is not None:
            self._worker.submit(item)
            # block for a recycled buffer, re-checking for consumer death
            # so a dead offload thread cannot strand us here
            with self.tracer.span("emit_wait", "stall"):
                while True:
                    try:
                        self._active = self._free.get(timeout=0.05)
                        return
                    except queue.Empty:
                        self._worker.raise_pending()
        else:
            self._process(item)
            self._active = self._free.get()

    def _process(self, item: tuple[int, int]) -> None:
        """Offload-thread body: dense transform, then hand results to the
        sink and recycle the buffer."""
        buf, n = item
        tr = self.tracer
        with tr.span("graduate_offload", "tail"):
            c0 = time.perf_counter()
            ids = self._buf_ids[buf][:n]
            rows = self._buf_rows[buf][:n]
            c1 = time.perf_counter()
            with tr.span("transform", "transform"):
                w0 = time.perf_counter()
                out = self.transform(rows)
                w1 = time.perf_counter()
            c2 = time.perf_counter()
            # the buffer is recycled below: nothing crossing into the sink
            # may alias it (identity transforms do; real dense updates
            # allocate)
            if np.shares_memory(out, self._buf_rows[buf]):
                out = out.copy()
            out_ids = ids.copy()
            c3 = time.perf_counter()
            with tr.span("sink", "sink"):
                w2 = time.perf_counter()
                self.sink(out_ids, out)
                w3 = time.perf_counter()
            self._free.put(buf)
            self._transform_s += w1 - w0
            self._sink_s += w3 - w2
            self._proc_s += (c1 - c0) + (c3 - c2)

    # ------------------------------------------------------------- flush
    def flush(self) -> None:
        """Emit any partial buffer.  Re-raises a deferred offload error
        (before touching the buffer) instead of silently dropping rows."""
        self._raise_pending()
        if self._fill:
            self._emit()

    # ------------------------------------------------------------- close
    def close(self) -> None:
        """Flush, stop the offload thread, and re-raise any deferred
        error.  Never returns with rows silently dropped: either every
        buffered row reached the sink or close() raises."""
        if self._closed:
            self._raise_pending()
            return
        self._closed = True
        try:
            self.flush()
        finally:
            if self._worker is not None:
                self._worker.close(raise_error=True)

    # ------------------------------------------------------------- stats
    @property
    def transform_seconds(self) -> float:
        return self._transform_s

    @property
    def sink_seconds(self) -> float:
        return self._sink_s

    @property
    def tail_seconds(self) -> float:
        """Busy time spent on graduation bookkeeping (buffering + emit +
        offload plumbing), excluding the dense transform and the sink."""
        return self._buffer_s + self._proc_s


class PythonGraduationProcessor(GraduationProcessor):
    """The seed's list-append + full-backlog ``np.concatenate`` strategy,
    kept bit-identical as the oracle/baseline.  Shares the fixed offload
    failure paths of the array implementation."""

    def __init__(self, *args, **kwargs):
        kwargs.pop("num_buffers", None)
        super().__init__(*args, **kwargs, num_buffers=2)
        self._ids: list[np.ndarray] = []
        self._rows: list[np.ndarray] = []
        self._count = 0

    def _init_buffers(self, n_buf: int) -> None:
        pass  # list-append strategy: no preallocated ring buffers

    def _recycle_dropped(self, item) -> None:
        pass  # items are (ids, rows) tuples, nothing to recycle

    def add(self, ids: np.ndarray, rows: np.ndarray) -> None:
        if len(ids) == 0:
            return
        self._raise_pending()
        with self.tracer.span("graduate_buffer", "tail"):
            t0 = time.perf_counter()
            self._ids.append(np.asarray(ids))
            self._rows.append(np.asarray(rows))
            self._count += len(ids)
            self.graduated += len(ids)
            self._buffer_s += time.perf_counter() - t0
            while self._count >= self.buffer_rows:
                self._emit_n(self.buffer_rows)

    def add_gather(self, ids, source, rows_index) -> None:
        self._raise_pending()
        self.add(ids, source[np.asarray(rows_index)].copy())

    def _emit_n(self, n_rows: int) -> None:
        self._raise_pending()
        t0 = time.perf_counter()
        ids = np.concatenate(self._ids)
        rows = np.concatenate(self._rows)
        take_ids, rest_ids = ids[:n_rows], ids[n_rows:]
        take_rows, rest_rows = rows[:n_rows], rows[n_rows:]
        self._ids = [rest_ids] if len(rest_ids) else []
        self._rows = [rest_rows] if len(rest_rows) else []
        self._count = len(rest_ids)
        self.offload_batches += 1
        self._buffer_s += time.perf_counter() - t0
        if self._worker is not None:
            self._worker.submit((take_ids, take_rows))
        else:
            self._process((take_ids, take_rows))

    def _process(self, item) -> None:
        ids, rows = item
        tr = self.tracer
        with tr.span("graduate_offload", "tail"):
            with tr.span("transform", "transform"):
                t0 = time.perf_counter()
                out = self.transform(rows)
                t1 = time.perf_counter()
            with tr.span("sink", "sink"):
                self.sink(ids, out)
                t2 = time.perf_counter()
            self._transform_s += t1 - t0
            self._sink_s += t2 - t1

    def flush(self) -> None:
        self._raise_pending()
        if self._count:
            self._emit_n(self._count)
