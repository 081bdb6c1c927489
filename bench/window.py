"""The measured window: its arithmetic, and the host sampler that reads
the process's resident set while it runs."""

from __future__ import annotations

import threading
import time

from bench.frozen.rss import read_rss_bytes


def whole_passes(start: float, pass_ends: list[float]) -> tuple[float, int]:
    """``(seconds, passes)`` of a window that ends at its last pass end:
    the loop stops at the first pass end past ``--seconds``, so every pass
    in it is whole."""
    if not pass_ends:
        raise ValueError("the window completed no pass")
    return pass_ends[-1] - start, len(pass_ends)


class RssSampler:
    """The highest resident set size seen by a thread that reads it every
    ``interval_s`` seconds, from ``start`` to ``stop``."""

    def __init__(self, interval_s: float = 0.01) -> None:
        self.interval_s = interval_s
        self.peak = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _sample(self) -> None:
        self.peak = max(self.peak, read_rss_bytes())
        self.samples += 1

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval_s)

    def start(self) -> "RssSampler":
        self._sample()
        self._thread = threading.Thread(target=self._run, name="bench-rss", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> int:
        """Stop, wait for the thread, and return the peak in bytes."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
            self._sample()
        return self.peak


clock = time.perf_counter  # the host clock every window is read on
