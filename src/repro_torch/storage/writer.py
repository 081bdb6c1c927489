"""Embedding writer (paper §3.7).

Transformed embeddings arrive in graduation order (arbitrary).  The writer
scatters incoming (ids, rows) batches into per-range-partition spill
buffers; when a buffer fills it is sorted by vertex ID and flushed as an
immutable sorted spill file.  Runs in a dedicated thread consuming a write
queue so GPU/compute never blocks on disk.

Two ingest strategies, selected by ``ingest_impl``:

* ``"array"`` (default) — one stable argsort (radix, O(N)) over the
  batch's partition labels splits it into contiguous per-partition runs
  in a single pass; each run is gathered *directly* into a preallocated
  per-partition arena (ids + rows) and a full arena flushes through a
  reusable sort scratch into ``write_spill``.  One copy per row, instead
  of the seed's O(P·N) boolean-mask scan and list-of-arrays
  concatenation (two copies plus a scan per partition).
* ``"python"`` — the seed's per-partition mask loop, kept bit-identical
  as the oracle/baseline for the layer-tail benchmark.

Failure paths (shared ``OffloadWorker`` semantics): a writer-thread error
is sticky — ``write`` re-raises it instead of blocking on a full queue,
and ``close`` first flushes whatever is still buffered (so already-queued
rows are never stranded in memory) and then re-raises, deterministically:
either close() returns a complete spill set or it raises.

Disk hand-off (``scheduler``): with a
``repro_torch.storage.io_scheduler.WritebackIOScheduler``, a full partition
arena is handed to the I/O thread by reference (the writer leases a
recycled arena back) and ``_flush_partition`` returns without touching
disk — sorting, serialization, and durability (group commit at the
layer barrier) all happen downstream, so ``spill_seconds`` shrinks to
the enqueue cost.  Without a scheduler the flush is the original
synchronous ``write_spill`` with per-file fsync (the
``io_impl="sync"`` oracle).  Scheduler errors ride the same sticky
protocol: they re-raise out of ``write``/``close`` or, at the latest,
out of the owner's ``barrier()``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.util.offload import OffloadWorker
from repro_torch.graphs.partition import RangePartition
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.spill import SpillSet, write_spill


class EmbeddingWriter:
    def __init__(
        self,
        out_dir: str,
        num_vertices: int,
        dim: int,
        dtype,
        num_partitions: int = 8,
        buffer_rows: int = 4096,
        stats: IOStats | None = None,
        queue_depth: int = 20,
        threaded: bool = True,
        ingest_impl: str = "array",
        scheduler=None,
        tracer=None,
    ):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.partition = RangePartition(num_vertices, num_partitions)
        self.dim = dim
        self.dtype = np.dtype(dtype)
        self.buffer_rows = max(1, buffer_rows)
        self.stats = stats if stats is not None else IOStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.spills = SpillSet()
        self.scheduler = scheduler  # borrowed: the owner barriers/closes it
        if ingest_impl not in ("array", "python"):
            raise ValueError(
                f"unknown ingest impl {ingest_impl!r} (want 'array'|'python')"
            )
        self.ingest_impl = ingest_impl
        P = num_partitions
        if ingest_impl == "array":
            # preallocated per-partition arenas + one shared sort scratch:
            # every batch and every flush moves through reused memory.
            # Separate arrays per partition (not one [P, R, d] block) so a
            # full arena can be handed to the write-back scheduler whole
            # and swapped for a recycled one.
            self._arena_ids = [
                np.empty(self.buffer_rows, dtype=np.uint64) for _ in range(P)
            ]
            self._arena_rows = [
                np.empty((self.buffer_rows, dim), dtype=self.dtype)
                for _ in range(P)
            ]
            self._scratch_ids = np.empty(self.buffer_rows, dtype=np.uint64)
            self._scratch_rows = np.empty((self.buffer_rows, dim), dtype=self.dtype)
        else:
            self._buf_ids: list[list[np.ndarray]] = [[] for _ in range(P)]
            self._buf_rows: list[list[np.ndarray]] = [[] for _ in range(P)]
        self._buf_count = [0] * P
        self._seq = 0
        self._rows_written = 0
        self._lock = threading.Lock()
        self._closed = False
        # busy-time split for the layer-tail benchmark: _ingest_s is
        # scatter/arena bookkeeping, _spill_s is write_spill (sort + disk)
        self._ingest_s = 0.0
        self._spill_s = 0.0
        self._worker: OffloadWorker | None = None
        if threaded:
            self._worker = OffloadWorker(
                lambda item: self._ingest(*item),
                name="atlas-writer",
                queue_depth=queue_depth,
            )

    # ------------------------------------------------------------ enqueue
    def write(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.asarray(ids, dtype=np.uint64)
        rows = np.asarray(rows, dtype=self.dtype)
        if len(ids) != len(rows):
            raise ValueError("ids and rows length mismatch")
        if self._worker is not None:
            self._worker.submit((ids, rows))
        else:
            self._ingest(ids, rows)

    # ------------------------------------------------------------- ingest
    def _ingest(self, ids: np.ndarray, rows: np.ndarray) -> None:
        with self.tracer.span("writer_ingest", "tail"):
            if self.ingest_impl == "array":
                self._ingest_array(ids, rows)
            else:
                self._ingest_python(ids, rows)

    def _ingest_array(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Split one batch into per-partition runs in a single argsort pass
        and gather each run *directly* into its arena (``np.take`` with
        ``out=``) — one copy per row, no intermediate sorted batch."""
        t0 = time.perf_counter()
        parts = self.partition.part_of(ids)
        # stable argsort on int32 labels is a radix sort: O(N); within one
        # partition the arrival order is preserved, matching the oracle
        order = np.argsort(parts, kind="stable")
        counts = np.bincount(parts, minlength=self.partition.num_parts)
        offsets = np.concatenate(([0], np.cumsum(counts)))
        spent = time.perf_counter() - t0
        for p in np.nonzero(counts)[0]:
            t0 = time.perf_counter()
            pos, end = int(offsets[p]), int(offsets[p + 1])
            while pos < end:
                fill = self._buf_count[p]
                take = min(self.buffer_rows - fill, end - pos)
                idx = order[pos : pos + take]
                # mode="clip" writes straight into the arena (indices are
                # argsort output, always in range; "raise" may buffer)
                np.take(ids, idx, out=self._arena_ids[p][fill : fill + take],
                        mode="clip")
                np.take(rows, idx, axis=0, mode="clip",
                        out=self._arena_rows[p][fill : fill + take])
                self._buf_count[p] = fill + take
                pos += take
                if self._buf_count[p] == self.buffer_rows:
                    spent += time.perf_counter() - t0
                    self._flush_partition(int(p))
                    t0 = time.perf_counter()
            spent += time.perf_counter() - t0
        self._ingest_s += spent

    def _ingest_python(self, ids: np.ndarray, rows: np.ndarray) -> None:
        t0 = time.perf_counter()
        parts = self.partition.part_of(ids)
        spent = time.perf_counter() - t0
        for p in np.unique(parts):
            t0 = time.perf_counter()
            sel = parts == p
            self._buf_ids[p].append(ids[sel])
            self._buf_rows[p].append(rows[sel])
            self._buf_count[p] += int(sel.sum())
            spent += time.perf_counter() - t0
            if self._buf_count[p] >= self.buffer_rows:
                self._flush_partition(int(p))
        self._ingest_s += spent

    # -------------------------------------------------------------- flush
    def _flush_partition(self, p: int) -> None:
        n = self._buf_count[p]
        if not n:
            return
        t0 = time.perf_counter()
        if self.ingest_impl == "array":
            ids = self._arena_ids[p][:n]
            rows = self._arena_rows[p][:n]
            scratch = (self._scratch_ids, self._scratch_rows)
        else:
            ids = np.concatenate(self._buf_ids[p])
            rows = np.concatenate(self._buf_rows[p])
            self._buf_ids[p].clear()
            self._buf_rows[p].clear()
            scratch = None
        self._buf_count[p] = 0
        with self._lock:
            seq = self._seq
            self._seq += 1
        path = os.path.join(self.out_dir, f"spill_p{p:04d}_{seq:06d}.spill")
        t1 = time.perf_counter()
        self.tracer.begin("spill_flush", "spill")
        try:
            w0 = time.perf_counter()
            if self.scheduler is not None:
                if self.ingest_impl == "array":
                    # hand the whole arena over (the I/O thread sorts and
                    # writes from it, then recycles it) and lease a
                    # replacement: the flush never blocks on disk
                    sf = self.scheduler.submit_spill(
                        path,
                        self._arena_ids[p],
                        self._arena_rows[p],
                        num_rows=n,
                        stats=self.stats,
                        recycle=True,
                    )
                    self._arena_ids[p], self._arena_rows[p] = (
                        self.scheduler.lease_arena(
                            self.buffer_rows, self.dim, self.dtype
                        )
                    )
                else:
                    # python oracle buffers are freshly concatenated arrays:
                    # hand them over by reference, nothing to recycle
                    sf = self.scheduler.submit_spill(
                        path, ids, rows, stats=self.stats
                    )
            else:
                sf = write_spill(
                    path, ids, rows, stats=self.stats, scratch=scratch
                )
            w1 = time.perf_counter()
        finally:
            self.tracer.end("spill_flush", "spill")
        with self._lock:
            self.spills.add(sf)
            self._rows_written += sf.num_rows
        self._ingest_s += t1 - t0
        self._spill_s += w1 - w0

    # -------------------------------------------------------------- close
    def close(self) -> SpillSet:
        """Flush all partial buffers; returns the spill set for this layer.

        Deterministic error handling: the writer thread is joined first,
        then *all* still-buffered partitions are flushed to disk, and only
        then is a deferred writer-thread error re-raised — buffered rows
        are never stranded in memory with no way to recover them."""
        deferred: BaseException | None = None
        if self._worker is not None and not self._closed:
            deferred = self._worker.close(raise_error=False)
        self._closed = True
        flush_exc: BaseException | None = None
        for p in range(self.partition.num_parts):
            try:
                self._flush_partition(p)
            except BaseException as exc:  # noqa: BLE001 - reported below
                flush_exc = flush_exc or exc
        if deferred is not None:
            if flush_exc is not None:
                raise deferred from flush_exc
            # a bare raise keeps any in-flight exception as __context__
            # (``from None`` would suppress it in double-failure tracebacks)
            raise deferred
        if flush_exc is not None:
            raise flush_exc
        return self.spills

    @property
    def rows_written(self) -> int:
        return self._rows_written

    @property
    def tail_seconds(self) -> float:
        """Busy time spent scattering/buffering rows, excluding the
        physical spill write (sort + disk) tracked in spill_seconds."""
        return self._ingest_s

    @property
    def spill_seconds(self) -> float:
        return self._spill_s
