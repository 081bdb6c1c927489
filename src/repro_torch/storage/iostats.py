"""Byte-level I/O accounting.

The paper's headline metric besides wall time is *bytes read from disk*
(/proc/<pid>/io, Fig 1 & 4 markers).  Every storage component takes an
``IOStats`` and records logical bytes moved, so the benchmark harness can
reproduce the read-amplification comparison exactly.

``QueueStats`` is the write-back scheduler's per-queue counterpart
(``repro_torch.storage.io_scheduler``): queue depth / bytes-in-flight highwater
marks, enqueue→start wait and service latency sums, and group-commit
barrier accounting, all updated from both the producer and the I/O
thread behind one lock.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class IOStats:
    bytes_read: int = 0
    bytes_written: int = 0
    num_reads: int = 0
    num_writes: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add_read(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_read += int(nbytes)
            self.num_reads += 1

    def add_write(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_written += int(nbytes)
            self.num_writes += 1

    def merge(self, other: "IOStats") -> None:
        with self._lock:
            self.bytes_read += other.bytes_read
            self.bytes_written += other.bytes_written
            self.num_reads += other.num_reads
            self.num_writes += other.num_writes

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "num_reads": self.num_reads,
                "num_writes": self.num_writes,
            }

    def reset(self) -> None:
        with self._lock:
            self.bytes_read = 0
            self.bytes_written = 0
            self.num_reads = 0
            self.num_writes = 0


@dataclasses.dataclass
class QueueStats:
    """Depth/latency accounting for one write-back I/O queue.

    Producers call ``record_enqueue`` (depth and bytes-in-flight go up),
    the I/O thread calls ``record_start`` when it picks a task up (queue
    wait accrues) and ``record_done``/``record_drop`` when the task
    finishes or is discarded after a consumer error (depth and bytes come
    back down).  ``record_barrier`` accrues group-commit cost.
    """

    name: str = "io"
    enqueued: int = 0
    completed: int = 0
    dropped: int = 0
    bytes_enqueued: int = 0
    bytes_inflight: int = 0
    bytes_inflight_peak: int = 0
    depth: int = 0
    depth_peak: int = 0
    queue_wait_seconds: float = 0.0  # submit -> picked up by the I/O thread
    service_seconds: float = 0.0  # picked up -> bytes handed to the OS
    barriers: int = 0
    barrier_seconds: float = 0.0
    fsyncs: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def record_enqueue(self, nbytes: int) -> None:
        with self._lock:
            self.enqueued += 1
            self.bytes_enqueued += int(nbytes)
            self.bytes_inflight += int(nbytes)
            self.bytes_inflight_peak = max(self.bytes_inflight_peak, self.bytes_inflight)
            self.depth += 1
            self.depth_peak = max(self.depth_peak, self.depth)

    def record_start(self, wait_seconds: float) -> None:
        with self._lock:
            self.queue_wait_seconds += float(wait_seconds)

    def record_done(self, nbytes: int, service_seconds: float) -> None:
        with self._lock:
            self.completed += 1
            self.bytes_inflight -= int(nbytes)
            self.depth -= 1
            self.service_seconds += float(service_seconds)

    def record_drop(self, nbytes: int) -> None:
        with self._lock:
            self.dropped += 1
            self.bytes_inflight -= int(nbytes)
            self.depth -= 1

    def record_barrier(self, seconds: float, fsyncs: int) -> None:
        with self._lock:
            self.barriers += 1
            self.barrier_seconds += float(seconds)
            self.fsyncs += int(fsyncs)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "enqueued": self.enqueued,
                "completed": self.completed,
                "dropped": self.dropped,
                "bytes_enqueued": self.bytes_enqueued,
                "bytes_inflight": self.bytes_inflight,
                "bytes_inflight_peak": self.bytes_inflight_peak,
                "depth": self.depth,
                "depth_peak": self.depth_peak,
                "queue_wait_seconds": self.queue_wait_seconds,
                "service_seconds": self.service_seconds,
                "barriers": self.barriers,
                "barrier_seconds": self.barrier_seconds,
                "fsyncs": self.fsyncs,
            }
