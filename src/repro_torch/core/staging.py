"""Chunk staging ring: overlap aggregation with delivery (paper §4).

The layer loop is a three-stage pipeline per chunk:

    read (ChunkReader thread) -> prep+aggregate -> deliver (main thread)

Serially, the main thread alternates aggregate and deliver, so the
device (or the numpy kernel) idles while ``_deliver`` routes rows and
vice versa.  ``StagedAggregation`` moves prep (edge weights, local ids)
and the ``aggregate()`` call — including its h2d staging — onto a
dedicated thread feeding a bounded ring (depth 2 by default): while the
main thread delivers chunk *k*, the stage thread is already transferring
and aggregating chunk *k+1*.  Results are handed over through a FIFO
queue, so chunks arrive **in index order** — delivery order, and hence
every downstream tie-break (eviction scores, graduation order, spill
contents), is identical to the serial loop.

``stall_seconds`` is the main thread's wait on the ring (pipeline
bubble); compare it with the aggregator's ``h2d_device_seconds`` to see
how much transfer the overlap actually hides.  On CUDA the aggregator owns
its own stream and pinned staging buffers (``core.broadcast``), so the
stage thread's copies and kernel launches never queue behind the
default stream.

The thread protocol mirrors ``storage.reader.ChunkReader``: bounded
queue, stop event checked on every timed put, ``None`` sentinel, errors
carried across and re-raised on the consumer thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator

from ..obs.trace import NULL_TRACER


class SerialAggregation:
    """Pass-through pipeline: aggregate on the caller's thread.

    Same interface as ``StagedAggregation`` (iteration yields
    ``(chunk, (u_dst, partial, counts))``; ``aggregate_seconds`` /
    ``stall_seconds`` attributes; ``close()``) so the layer loop is
    written once.  ``stall_seconds`` is always zero — there is no ring
    to wait on.
    """

    staged = False

    def __init__(
        self,
        chunks: Iterable,
        prep: Callable,
        aggregate: Callable,
        tracer=None,
    ) -> None:
        self._chunks = chunks
        self._prep = prep
        self._aggregate = aggregate
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.aggregate_seconds = 0.0
        self.stall_seconds = 0.0

    def aggregator_seconds(self, field: str) -> float:
        """A time counter of the aggregator this pipeline owns
        (``h2d_seconds``, ``h2d_device_seconds``, ``d2h_device_seconds``;
        0.0 for host-only aggregators like numpy)."""
        return getattr(self._aggregate, field, 0.0)

    def __iter__(self) -> Iterator:
        tr = self.tracer
        for chunk in self._chunks:
            with tr.span("prep", "prep", id=chunk.index):
                src_local, dst, w = self._prep(chunk)
            with tr.span("aggregate", "aggregate", id=chunk.index):
                t0 = time.perf_counter()
                result = self._aggregate(chunk.feats, src_local, dst, w)
                self.aggregate_seconds += time.perf_counter() - t0
            yield chunk, result

    def close(self) -> None:
        close = getattr(self._chunks, "close", None)
        if close is not None:
            close()


class StagedAggregation:
    """Bounded staging ring running prep+aggregate one chunk ahead."""

    staged = True

    def __init__(
        self,
        chunks: Iterable,
        prep: Callable,
        aggregate: Callable,
        depth: int = 2,
        tracer=None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"staging depth must be >= 1, got {depth}")
        self._chunks = chunks
        self._prep = prep
        self._aggregate = aggregate
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._errors: list[BaseException] = []
        self._thread: threading.Thread | None = None
        self.aggregate_seconds = 0.0
        self.stall_seconds = 0.0

    def aggregator_seconds(self, field: str) -> float:
        """A time counter of the pipeline-owned aggregator, as
        ``SerialAggregation.aggregator_seconds``.

        Safe to read after iteration completes: the generator's close (or
        exhaustion) joins the stage thread, so the worker's last update
        happens-before this read.
        """
        return getattr(self._aggregate, field, 0.0)

    # ------------------------------------------------------ stage thread
    def _put_checked(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        tr = self.tracer
        try:
            for chunk in self._chunks:
                if self._stop.is_set():
                    break
                with tr.span("prep", "prep", id=chunk.index):
                    src_local, dst, w = self._prep(chunk)
                with tr.span("aggregate", "aggregate", id=chunk.index):
                    t0 = time.perf_counter()
                    result = self._aggregate(chunk.feats, src_local, dst, w)
                    self.aggregate_seconds += time.perf_counter() - t0
                if not self._put_checked((chunk, result)):
                    break
        except BaseException as e:  # noqa: BLE001 — carried to consumer
            self._errors.append(e)
        finally:
            self._put_checked(None)

    # ----------------------------------------------------- consumer side
    def __iter__(self) -> Iterator:
        t = threading.Thread(
            target=self._worker, name="atlas-staging", daemon=True
        )
        self._thread = t
        t.start()
        tr = self.tracer
        try:
            while True:
                # one stall span covers the whole wait for this item,
                # however many 0.05s poll ticks it takes, and
                # stall_seconds times the same region (the trace
                # reconciles with it)
                tr.begin("ring_wait", "stall")
                t0 = time.perf_counter()
                try:
                    while True:
                        try:
                            item = self._q.get(timeout=0.05)
                        except queue.Empty:
                            if not t.is_alive() and self._q.empty():
                                # thread died without managing to queue
                                # its sentinel (stop raced it) — surface
                                # the error
                                item = None
                                break
                            continue
                        break
                finally:
                    self.stall_seconds += time.perf_counter() - t0
                    tr.end("ring_wait", "stall")
                if item is None:
                    break
                yield item
        finally:
            self.close()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        """Stop the stage thread, then close the underlying iterator.

        Order matters: the chunk generator can only be closed once the
        stage thread is no longer executing inside it.
        """
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        close = getattr(self._chunks, "close", None)
        if close is not None:
            close()


def make_aggregation_pipeline(
    mode: str,
    backend: str,
    threaded: bool,
    chunks: Iterable,
    prep: Callable,
    aggregate: Callable,
    depth: int = 2,
    tracer=None,
):
    """'serial', 'staged', or 'auto' (staged for the torch backends when
    the engine runs threaded; the numpy backend stays serial — its
    aggregate shares the delivery thread's cores anyway)."""
    if mode == "auto":
        mode = (
            "staged" if threaded and backend != "numpy" else "serial"
        )
    if mode == "serial":
        return SerialAggregation(chunks, prep, aggregate, tracer=tracer)
    if mode == "staged":
        return StagedAggregation(
            chunks, prep, aggregate, depth=depth, tracer=tracer
        )
    raise ValueError(f"unknown pipeline mode {mode!r}")
