"""Offload-thread plumbing shared by the layer tail (paper §3.6–3.7).

Both tail stages — the graduation transform and the spill writer — push
work through a bounded queue to a dedicated consumer thread.  The seed
implementation had two failure-path bugs this module exists to fix:

1. *Producer deadlock on consumer death.*  Producers checked the
   deferred-error slot only **before** ``q.put``; if the consumer thread
   died while the bounded queue was full, the blocking put never
   returned.  ``submit`` uses a timed put and re-checks the error slot
   on every timeout, and the consumer loop keeps **draining** (and
   discarding) items after an error until the close sentinel arrives, so
   a blocked producer always unblocks within one timeout tick.

2. *Silent item loss without a report.*  An error captured on the
   consumer thread is sticky: every later ``submit`` and the final
   ``close`` re-raise it, so callers can never mistake a partially
   consumed stream for a complete one.  Items drained after the error
   are handed to ``on_drop`` (e.g. so a ring buffer can be recycled);
   the layer-as-transaction recovery model makes dropping safe — a
   failed layer is discarded and replayed from the previous layer's
   immutable spills.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

_PUT_TICK_S = 0.05


class OffloadWorker:
    """Bounded work queue + consumer thread with sticky deferred errors.

    ``fn(item)`` runs on the consumer thread.  After ``fn`` raises, the
    worker records the exception, keeps draining the queue (calling
    ``on_drop`` per discarded item) until the close sentinel, and every
    producer-side call re-raises the recorded error.
    """

    def __init__(
        self,
        fn: Callable[[Any], None],
        name: str,
        queue_depth: int = 20,
        on_drop: Callable[[Any], None] | None = None,
    ):
        self._fn = fn
        self._on_drop = on_drop
        self._q: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        self._err: list[BaseException] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ errors
    def pending_error(self) -> BaseException | None:
        return self._err[0] if self._err else None

    def raise_pending(self) -> None:
        if self._err:
            raise self._err[0]

    # ---------------------------------------------------------- producer
    def submit(self, item: Any) -> None:
        """Enqueue ``item``; raises the deferred consumer error instead of
        blocking forever when the consumer has died."""
        if self._closed:
            raise RuntimeError("submit() after close()")
        self.raise_pending()
        while True:
            try:
                self._q.put(item, timeout=_PUT_TICK_S)
                return
            except queue.Full:
                # consumer may have died while we waited; the drain loop
                # below guarantees this check eventually observes it
                self.raise_pending()

    def drain(self) -> None:
        """Block until every item submitted so far has been consumed —
        processed by ``fn`` or discarded through ``on_drop`` after an
        error.  This is the write-back scheduler's barrier primitive: it
        waits for in-flight work without shutting the consumer down, and
        it cannot hang on a dead consumer because the loop keeps draining
        (and acknowledging) items after an error.  A deferred error is
        NOT raised here; callers sequence ``raise_pending`` themselves.
        """
        self._q.join()

    def close(self, raise_error: bool = True) -> BaseException | None:
        """Send the sentinel, join the consumer, and surface any deferred
        error — raised (default) or returned so the caller can sequence
        its own cleanup first (e.g. flush-then-report)."""
        if not self._closed:
            self._closed = True
            # the consumer drains even after an error, so this cannot block
            self._q.put(None)
            self._thread.join()
        err = self.pending_error()
        if err is not None and raise_error:
            raise err
        return err

    # ---------------------------------------------------------- consumer
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                if self._err:
                    if self._on_drop is not None:
                        self._on_drop(item)
                    continue
                try:
                    self._fn(item)
                except BaseException as exc:  # noqa: BLE001 - deferred to producer
                    self._err.append(exc)
                    if self._on_drop is not None:
                        self._on_drop(item)
            finally:
                # every item is acknowledged exactly once, even on the
                # error/drop paths, so drain() always terminates
                self._q.task_done()
