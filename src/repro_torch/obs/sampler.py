"""Background resource sampler: RSS + cumulative disk I/O from /proc/self.

Polls at a configurable interval on a daemon thread and records each
sample into ``Gauge`` timeseries (last/min/max) and, when a tracer is
attached, Perfetto counter tracks — so the memory/disk curves line up
under the span timeline.

Out-of-core inference lives or dies on these two curves: RSS should stay
flat at the configured budget while disk read/write bytes climb, layer
after layer.  A rising RSS slope is a leak in the arena recycling; a
flat disk-read curve during an "aggregate" phase means the page cache is
hiding the streaming cost.
"""

from __future__ import annotations

import os
import threading
import time

from .metrics import MetricsRegistry
from .trace import NULL_TRACER

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def read_rss_bytes() -> int:
    """Resident set size from /proc/self/statm (0 where unsupported)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return 0


def read_disk_bytes() -> tuple[int, int]:
    """Cumulative (read_bytes, write_bytes) actually hitting the block
    layer, from /proc/self/io ((0, 0) where unsupported)."""
    rd = wr = 0
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("read_bytes:"):
                    rd = int(line.split()[1])
                elif line.startswith("write_bytes:"):
                    wr = int(line.split()[1])
    except (OSError, IndexError, ValueError):
        pass
    return rd, wr


class ResourceSampler:
    """Samples process resources on a background thread.

    ``start()``/``stop()`` are idempotent; ``stop()`` joins the thread
    and takes one final sample so short runs still get end-state data.
    Use as a context manager around a traced region.
    """

    def __init__(self, interval_s: float = 0.1, registry=None,
                 tracer=None) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.interval_s = interval_s
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.num_samples = 0

    # ------------------------------------------------------------- control
    def start(self) -> "ResourceSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="atlas-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join()
        self._thread = None
        self._sample()  # final sample: capture end-of-run state

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "ResourceSampler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------------ sampling
    def _sample(self) -> None:
        rss = read_rss_bytes()
        rd, wr = read_disk_bytes()
        reg = self.registry
        reg.gauge("resources.rss_bytes").set(rss)
        reg.gauge("resources.disk_read_bytes").set(rd)
        reg.gauge("resources.disk_write_bytes").set(wr)
        tr = self.tracer
        if tr.enabled:
            tr.counter("rss_mb", rss / 1e6)
            tr.counter("disk_read_mb", rd / 1e6)
            tr.counter("disk_write_mb", wr / 1e6)
        self.num_samples += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            self._sample()
            # sleep the remainder of the interval, interruptibly
            delay = self.interval_s - (time.monotonic() - t0)
            if delay > 0:
                self._stop.wait(delay)

    def snapshot(self) -> dict:
        return self.registry.snapshot().get("resources", {})


__all__ = ["ResourceSampler", "read_disk_bytes", "read_rss_bytes"]
