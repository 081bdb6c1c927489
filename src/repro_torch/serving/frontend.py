"""Batching front-end for embedding lookups: many callers, one reader.

A pinned ``SessionReader`` answers one ``lookup`` at a time, and its
throughput comes from batching — dedup, per-file binary searches, and
gathers all amortize over the ids in one call.  Request threads that
each issue tiny lookups forfeit that; ``ServingFrontend`` gets it back
by *coalescing*: callers ``submit`` id arrays and get futures, a single
dispatcher thread drains the queue in **waves**, and each wave becomes
ONE deduplicated ``reader.lookup`` whose rows are demuxed back to every
request in it.

Wave formation follows the LM engine's aligned-batching policy
(serving/engine.py) with two knobs:

* ``max_batch`` — a wave closes as soon as the queued requests cover at
  least this many ids (a single oversized request still goes through,
  as its own wave);
* ``max_delay_s`` — a wave closes no later than this long after its
  *oldest* request was queued, bounding the latency a sparse trickle of
  traffic pays for batching.

Missing ids fail **per request**: the batched lookup's ``KeyError``
triggers one fallback lookup per member request, so a poisoned request
errors its own future and everyone else still gets rows.

All rows come back bit-identical to per-request ``reader.lookup`` calls
— the wave is a concatenation, the reader dedups internally, and the
demux is a pure slice of the batched result.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class LookupFuture:
    """One submitted lookup's pending result.

    ``result()`` blocks until the dispatcher serves the wave containing
    this request, then returns the rows (request order, duplicates
    preserved) or raises the per-request error (``KeyError`` for ids
    absent from the layer)."""

    __slots__ = ("ids", "_event", "_rows", "_error", "enqueued_at")

    def __init__(self, ids: np.ndarray, enqueued_at: float):
        self.ids = ids
        self.enqueued_at = enqueued_at
        self._event = threading.Event()
        self._rows: np.ndarray | None = None
        self._error: BaseException | None = None

    def _resolve(self, rows: np.ndarray) -> None:
        self._rows = rows
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("lookup not served within timeout")
        if self._error is not None:
            raise self._error
        return self._rows


class ServingFrontend:
    """Coalesce concurrent embedding lookups into batched reader calls.

    ``reader`` is anything with a ``lookup(ids) -> rows`` method — a
    pinned ``repro_torch.session.SessionReader`` in production, a plain
    ``VertexQueryEngine`` in tests.  One dispatcher thread serves all
    submitters; the reader is only ever called from that thread, so a
    single (engine-counter-unsynchronized) reader is safe under any
    number of client threads.

    ``metrics`` (an ``obs.MetricsRegistry``) exports
    ``serve.frontend.requests|waves|ids|unique_ids|errors`` counters and
    a ``serve.frontend.wait_s`` histogram (submit -> resolve latency).
    """

    def __init__(
        self,
        reader,
        max_batch: int = 4096,
        max_delay_s: float = 0.002,
        metrics=None,
        clock=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.reader = reader
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self._clock = clock if clock is not None else time.monotonic
        self._cond = threading.Condition()
        self._queue: list[LookupFuture] = []
        self._queued_ids = 0
        self._stopping = False
        self._thread: threading.Thread | None = None
        # local counters (always on); registry export optional
        self.requests = 0
        self.waves = 0
        self.batched_ids = 0
        self.unique_ids = 0
        self.errors = 0
        self._m_requests = self._m_waves = self._m_ids = None
        self._m_unique = self._m_errors = self._m_wait = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, registry, prefix: str = "serve.frontend") -> None:
        self._m_requests = registry.counter(f"{prefix}.requests")
        self._m_waves = registry.counter(f"{prefix}.waves")
        self._m_ids = registry.counter(f"{prefix}.ids")
        self._m_unique = registry.counter(f"{prefix}.unique_ids")
        self._m_errors = registry.counter(f"{prefix}.errors")
        self._m_wait = registry.histogram(f"{prefix}.wait_s")

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("ServingFrontend already started")
        self._stopping = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="serving-frontend", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain every queued request, then stop the dispatcher.
        Idempotent; submits after stop raise."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit
    def submit(self, vertex_ids: np.ndarray) -> LookupFuture:
        """Queue one lookup; returns immediately with its future."""
        ids = np.asarray(vertex_ids, dtype=np.uint64).ravel()
        fut = LookupFuture(ids, self._clock())
        with self._cond:
            if self._stopping or self._thread is None:
                raise RuntimeError("ServingFrontend is not running")
            self._queue.append(fut)
            self._queued_ids += len(ids)
            self._cond.notify_all()
        self.requests += 1
        if self._m_requests is not None:
            self._m_requests.inc()
        return fut

    def lookup(self, vertex_ids: np.ndarray, timeout: float | None = None):
        """Synchronous convenience: ``submit`` + ``result``."""
        return self.submit(vertex_ids).result(timeout)

    # ----------------------------------------------------------- dispatch
    def _take_wave(self) -> list[LookupFuture] | None:
        """Block until a wave is due (enough ids queued, the oldest
        request's deadline passed, or draining at stop); None only when
        stopped AND drained."""
        with self._cond:
            while True:
                if self._queue:
                    if (
                        self._stopping
                        or self._queued_ids >= self.max_batch
                        or self._clock() - self._queue[0].enqueued_at
                        >= self.max_delay_s
                    ):
                        wave: list[LookupFuture] = []
                        n = 0
                        while self._queue and (not wave or n < self.max_batch):
                            fut = self._queue.pop(0)
                            wave.append(fut)
                            n += len(fut.ids)
                        self._queued_ids -= n
                        return wave
                    # not due yet: sleep until the oldest deadline
                    budget = self.max_delay_s - (
                        self._clock() - self._queue[0].enqueued_at
                    )
                    self._cond.wait(timeout=max(0.0, budget))
                elif self._stopping:
                    return None
                else:
                    self._cond.wait()

    def _serve_wave(self, wave: list[LookupFuture]) -> None:
        sizes = [len(f.ids) for f in wave]
        batched = (
            np.concatenate([f.ids for f in wave])
            if len(wave) > 1
            else wave[0].ids
        )
        self.waves += 1
        self.batched_ids += len(batched)
        uniq = len(np.unique(batched)) if len(batched) else 0
        self.unique_ids += uniq
        if self._m_waves is not None:
            self._m_waves.inc()
            self._m_ids.inc(len(batched))
            self._m_unique.inc(uniq)
        try:
            rows = self.reader.lookup(batched)
        except KeyError:
            # one or more requests carry missing ids — isolate the blast
            # radius with per-request fallback lookups
            for fut in wave:
                try:
                    fut._resolve(self.reader.lookup(fut.ids))
                except BaseException as e:
                    self.errors += 1
                    if self._m_errors is not None:
                        self._m_errors.inc()
                    fut._fail(e)
            self._observe_wait(wave)
            return
        except BaseException as e:
            for fut in wave:
                self.errors += 1
                if self._m_errors is not None:
                    self._m_errors.inc()
                fut._fail(e)
            self._observe_wait(wave)
            return
        off = 0
        for fut, n in zip(wave, sizes):
            fut._resolve(rows[off : off + n])
            off += n
        self._observe_wait(wave)

    def _observe_wait(self, wave: list[LookupFuture]) -> None:
        if self._m_wait is None:
            return
        now = self._clock()
        for fut in wave:
            self._m_wait.observe(max(0.0, now - fut.enqueued_at))

    def _dispatch_loop(self) -> None:
        while True:
            wave = self._take_wave()
            if wave is None:
                return
            self._serve_wave(wave)

    # ----------------------------------------------------------- metrics
    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "waves": self.waves,
            "batched_ids": self.batched_ids,
            "unique_ids": self.unique_ids,
            "errors": self.errors,
            "ids_per_wave": self.batched_ids / self.waves if self.waves else 0.0,
            "dedup_ratio": (
                self.unique_ids / self.batched_ids if self.batched_ids else 0.0
            ),
        }


__all__ = ["LookupFuture", "ServingFrontend"]
