"""Write-back I/O scheduler: spill writes off the layer critical path.

The engine's broadcast model (paper §3) only pays off if each layer is
one sequential streaming pass, but the original tail blocked on a
synchronous ``write_spill`` + per-file ``fsync`` for every flushed
partition.  This module moves the physical write behind a dedicated I/O
thread and moves durability from fsync-per-spill to **group commit**:

* ``submit_spill`` is enqueue-and-continue.  The caller hands the
  (unsorted) batch over — either by reference (freshly allocated arrays,
  compaction's case) or by swapping its preallocated write arena for a
  recycled one from the scheduler's pool (the spill writer's case) — and
  immediately gets back the ``SpillFile`` descriptor; sorting,
  serialization, and the page-cache write all happen on the I/O thread.
* ``barrier`` is the single deferred durability point: drain the queue,
  surface any deferred I/O error, then fsync every dirty file and every
  containing directory once.  The engine barriers once per layer (before
  the run manifest advances) and the publish path barriers once per
  publish (before the staged version dir is renamed into place), which
  preserves the crash-consistency ordering *data durable → manifest
  pointer swap* end to end.

Failure semantics are the shared ``OffloadWorker`` sticky-error
protocol: an I/O-thread error is recorded, later ``submit_spill`` calls
re-raise it, queued tasks drain (recycling their arenas) instead of
deadlocking producers, and the error always surfaces at (or before) the
barrier — a crashed write can never be mistaken for a committed layer.
``close`` drains outstanding writes and then barriers, so a scheduler is
never torn down with bytes still volatile (pass ``commit=False`` on
abandon-the-layer error paths, where the partial output is discarded
anyway).

File contents are bit-identical to the synchronous path: the same
``write_spill`` runs on the I/O thread with ``durability="deferred"``,
only *when* the bytes become durable changes.  ``AtlasConfig.io_impl``
keeps the synchronous path around as the oracle.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.storage.iostats import IOStats, QueueStats
from repro_torch.storage.spill import DEFAULT_BLOCK_ROWS, SpillFile, write_spill
from repro_torch.util.offload import OffloadWorker

_ARENA_TICK_S = 0.05
_POOL_MAX = 16  # recycled arenas kept per scheduler before excess is freed


def fsync_dir(path: str) -> bool:
    """fsync a directory so renames/creates inside it are durable.

    Returns False (instead of raising) where directories cannot be
    opened or fsynced — the group commit is then as durable as the
    platform allows, matching the pre-scheduler behavior."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        os.fsync(fd)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def make_scheduler(
    impl: str, queue_depth: int = 8, stats: QueueStats | None = None,
    tracer=None,
) -> "WritebackIOScheduler | None":
    """``None`` for ``"sync"`` (callers fall back to inline
    ``write_spill`` with per-file fsync — today's oracle path), a
    ``WritebackIOScheduler`` for ``"writeback"``."""
    if impl == "sync":
        return None
    if impl == "writeback":
        return WritebackIOScheduler(
            queue_depth=queue_depth, stats=stats, tracer=tracer
        )
    raise ValueError(f"unknown io impl {impl!r} (want 'writeback'|'sync')")


class _SpillTask:
    """One queued spill write.  ``ids``/``rows`` may be larger than
    ``num_rows`` (a handed-over write arena); ``recycle`` returns them to
    the arena pool once the bytes are with the OS."""

    __slots__ = (
        "path", "ids", "rows", "num_rows", "presorted", "block_rows",
        "stats", "recycle", "nbytes", "enqueued_at",
    )

    def __init__(self, path, ids, rows, num_rows, presorted, block_rows,
                 stats, recycle, nbytes, enqueued_at):
        self.path = path
        self.ids = ids
        self.rows = rows
        self.num_rows = num_rows
        self.presorted = presorted
        self.block_rows = block_rows
        self.stats = stats
        self.recycle = recycle
        self.nbytes = nbytes
        self.enqueued_at = enqueued_at


class WritebackIOScheduler:
    """Shared write-back scheduler: one I/O thread, an arena pool, a
    dirty set, and a group-commit barrier.

    Thread model: any number of producer threads may ``submit_spill`` /
    ``lease_arena`` concurrently (the spill writer's offload thread and
    the publish path both do); ``barrier``/``close`` are called by the
    owner.  All shared state is behind locks or the worker queue.
    """

    def __init__(
        self,
        queue_depth: int = 8,
        stats: QueueStats | None = None,
        name: str = "atlas-io",
        tracer=None,
    ):
        self.qstats = stats if stats is not None else QueueStats(name=name)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._dirty_lock = threading.Lock()
        self._dirty_files: set[str] = set()
        self._dirty_dirs: set[str] = set()
        self._pool_lock = threading.Lock()
        self._pool: list[tuple[np.ndarray, np.ndarray]] = []
        # I/O-thread-private sort scratch, grown on demand per (dtype, dim)
        self._scratch: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
        self._barrier_s = 0.0
        self._closed = False
        self._worker = OffloadWorker(
            self._write,
            name=name,
            queue_depth=queue_depth,
            on_drop=self._drop,
        )

    # ------------------------------------------------------------- arenas
    def lease_arena(
        self, num_rows: int, dim: int, dtype
    ) -> tuple[np.ndarray, np.ndarray]:
        """A ``(ids, rows)`` write arena of at least ``num_rows``
        capacity — recycled from a completed write when one of a
        compatible shape is free, freshly allocated otherwise.  Never
        blocks, so a producer waiting for an arena cannot deadlock on a
        dead I/O thread; memory stays bounded by the queue depth."""
        dtype = np.dtype(dtype)
        with self._pool_lock:
            for i, (ids, rows) in enumerate(self._pool):
                if (
                    len(ids) >= num_rows
                    and rows.shape[1] == dim
                    and rows.dtype == dtype
                ):
                    return self._pool.pop(i)
        return (
            np.empty(num_rows, dtype=np.uint64),
            np.empty((num_rows, dim), dtype=dtype),
        )

    def _recycle(self, ids: np.ndarray, rows: np.ndarray) -> None:
        with self._pool_lock:
            if len(self._pool) < _POOL_MAX:
                self._pool.append((ids, rows))

    # ------------------------------------------------------------- submit
    def submit_spill(
        self,
        path: str,
        ids: np.ndarray,
        rows: np.ndarray,
        num_rows: int | None = None,
        stats: IOStats | None = None,
        presorted: bool = False,
        block_rows: int | None = DEFAULT_BLOCK_ROWS,
        recycle: bool = False,
    ) -> SpillFile:
        """Enqueue one spill write and return its descriptor immediately.

        ``ids``/``rows`` are handed over: the caller must not touch them
        again (swap in a ``lease_arena`` replacement, or pass freshly
        allocated arrays).  ``recycle=True`` returns them to the arena
        pool after the write.  The descriptor's id bounds are computed
        here in O(n); the file itself exists only after the queue
        reaches it and is durable only after the next ``barrier``.
        Re-raises a deferred I/O-thread error instead of enqueueing
        after one."""
        n = len(ids) if num_rows is None else int(num_rows)
        dim = int(rows.shape[1])
        dtype = np.dtype(rows.dtype)
        if n:
            if presorted:
                mn, mx = int(ids[0]), int(ids[n - 1])
            else:
                head = ids[:n]
                mn, mx = int(head.min()), int(head.max())
        else:
            mn = mx = 0
        nbytes = n * (8 + dim * dtype.itemsize)
        task = _SpillTask(
            path, ids, rows, n, presorted, block_rows, stats, recycle,
            nbytes, time.perf_counter(),
        )
        self.qstats.record_enqueue(nbytes)
        try:
            self._worker.submit(task)
        except BaseException:
            self.qstats.record_drop(nbytes)
            if recycle:
                self._recycle(ids, rows)
            raise
        return SpillFile(
            path=path, num_rows=n, dim=dim, dtype=dtype, min_id=mn, max_id=mx
        )

    # -------------------------------------------------------- I/O thread
    def _scratch_for(self, n: int, dim: int, dtype) -> tuple[np.ndarray, np.ndarray]:
        key = (np.dtype(dtype), dim)
        sc = self._scratch.get(key)
        if sc is None or len(sc[0]) < n:
            sc = (
                np.empty(n, dtype=np.uint64),
                np.empty((n, dim), dtype=dtype),
            )
            self._scratch[key] = sc
        return sc

    def _write(self, task: _SpillTask) -> None:
        t0 = time.perf_counter()
        self.qstats.record_start(t0 - task.enqueued_at)
        with self.tracer.span("spill_write", "spill"):
            try:
                scratch = None
                if not task.presorted:
                    scratch = self._scratch_for(
                        task.num_rows, task.rows.shape[1], task.rows.dtype
                    )
                write_spill(
                    task.path,
                    task.ids[: task.num_rows],
                    task.rows[: task.num_rows],
                    stats=task.stats,
                    presorted=task.presorted,
                    block_rows=task.block_rows,
                    scratch=scratch,
                    durability="deferred",
                )
                self.note_dirty(task.path)
            finally:
                # success is accounted here; an erroring task falls through
                # to the worker's on_drop (_drop), which does the drop
                # accounting
                if task.recycle:
                    self._recycle(task.ids, task.rows)
                    task.recycle = False  # _drop must not double-recycle
        self.qstats.record_done(task.nbytes, time.perf_counter() - t0)

    def _drop(self, task: _SpillTask) -> None:
        """Drained-after-error path: recycle the arena, keep accounting
        exact.  Dropping is safe — the owner's barrier raises, and the
        layer/publish that produced these bytes is discarded."""
        if task.recycle:
            self._recycle(task.ids, task.rows)
            task.recycle = False
        self.qstats.record_drop(task.nbytes)

    # -------------------------------------------------------- durability
    def note_dirty(self, path: str) -> None:
        """Record a file (and its directory) as needing fsync at the next
        barrier.  Writes that bypass ``submit_spill`` but want group
        commit (e.g. small sidecars) can call this directly."""
        with self._dirty_lock:
            self._dirty_files.add(path)
            self._dirty_dirs.add(os.path.dirname(os.path.abspath(path)))

    def drain(self) -> None:
        """Wait until every queued write has reached the OS and surface
        any deferred I/O error.  After ``drain`` the files *exist* and
        are readable (the next layer may stream them); they are durable
        only after the next ``barrier``.  This split is what lets the
        engine overlap the fsync group commit with the next layer's
        reads without racing them against unwritten files."""
        with self.tracer.span("queue_drain", "drain"):
            self._worker.drain()
        self._worker.raise_pending()

    def barrier(self) -> float:
        """Group commit: drain the queue, surface any deferred error,
        then fsync every dirty file and containing directory once.
        Returns the seconds this call blocked — the only durability cost
        left on the caller's critical path."""
        self.tracer.begin("group_commit", "barrier")
        try:
            t0 = time.perf_counter()
            self._worker.drain()
            # consumer death / write failure surfaces here, never silently
            self._worker.raise_pending()
            with self._dirty_lock:
                files = sorted(self._dirty_files)
                dirs = sorted(self._dirty_dirs)
                self._dirty_files.clear()
                self._dirty_dirs.clear()
            n_sync = 0
            with self.tracer.span("fsync_pass", "fsync"):
                for p in files:
                    with open(p, "rb") as f:
                        os.fsync(f.fileno())
                    n_sync += 1
                for d in dirs:
                    if fsync_dir(d):
                        n_sync += 1
            seconds = time.perf_counter() - t0
        finally:
            self.tracer.end("group_commit", "barrier")
        self._barrier_s += seconds
        self.qstats.record_barrier(seconds, n_sync)
        return seconds

    # ------------------------------------------------------------- close
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def barrier_seconds(self) -> float:
        return self._barrier_s

    def close(
        self, commit: bool = True, raise_error: bool = True
    ) -> BaseException | None:
        """Drain outstanding writes, group-commit them (unless
        ``commit=False`` — abandoned-layer cleanup, where the output is
        discarded), stop the I/O thread, and surface any deferred
        error."""
        err: BaseException | None = None
        if not self._closed:
            self._closed = True
            if commit:
                try:
                    self.barrier()
                except BaseException as exc:  # noqa: BLE001 - reported below
                    err = exc
            werr = self._worker.close(raise_error=False)
            if err is None:
                err = werr
        else:
            err = self._worker.pending_error()
        if err is not None and raise_error:
            raise err
        return err


__all__ = [
    "WritebackIOScheduler",
    "make_scheduler",
    "fsync_dir",
]
