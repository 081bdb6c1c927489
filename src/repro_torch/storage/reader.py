"""Pseudo-sequential chunked graph reader (paper §3.3).

Yields ``Chunk``s: a contiguous source-vertex ID range with (a) its CSR
topology slice and (b) its features/embeddings assembled by merge-on-read
over the sorted spill files of the previous layer.  Runs in a dedicated
thread feeding a bounded queue, so disk I/O runs ahead of compute
(backpressure = the paper's observed read-rate throttling, Fig 5g).

Chunk boundaries are defined by *feature bytes*, not edge volume (paper
§3.3): a high-degree vertex increases per-chunk edge work but never changes
the feature-read ordering.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.graphs.csr import CSRGraph
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.spill import SpillSet


@dataclasses.dataclass
class Chunk:
    index: int
    start_id: int
    end_id: int  # exclusive
    ids: np.ndarray  # uint64 [n] == arange(start, end)
    feats: np.ndarray  # [n, d]
    edge_src: np.ndarray  # [m] source ids (within [start,end))
    edge_dst: np.ndarray  # [m] destination ids (global)

    @property
    def num_vertices(self) -> int:
        return self.end_id - self.start_id

    @property
    def num_edges(self) -> int:
        return len(self.edge_dst)


class ChunkReader:
    """Iterator over chunks of the (topology, previous-layer embeddings).

    ``order``: optional relabel-free processing order is NOT supported here —
    ATLAS reordering physically relabels the graph (paper §3.8), so the
    reader always streams ascending vertex IDs; reordering happens upstream.
    """

    def __init__(
        self,
        csr: CSRGraph,
        spills: SpillSet,
        feat_dim: int,
        feat_dtype,
        chunk_bytes: int = 8 * 1024 * 1024,
        stats: IOStats | None = None,
        prefetch_depth: int = 4,
        num_vertices: int | None = None,
        tracer=None,
        vertex_range: tuple[int, int] | None = None,
    ):
        self.csr = csr
        self.spills = spills
        self.feat_dim = feat_dim
        self.feat_dtype = np.dtype(feat_dtype)
        self.stats = stats if stats is not None else IOStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.prefetch_depth = prefetch_depth
        self.num_vertices = num_vertices or csr.num_vertices
        # restrict the stream to one contiguous source-id range (shard
        # workers: each shard reads only its own sources, still one
        # sequential pass); default = the whole graph
        self.vertex_range = (
            (0, self.num_vertices) if vertex_range is None else
            (int(vertex_range[0]), int(vertex_range[1]))
        )
        lo, hi = self.vertex_range
        if not (0 <= lo <= hi <= self.num_vertices):
            raise ValueError(
                f"vertex_range {vertex_range} outside [0, {self.num_vertices}]"
            )
        row_bytes = self.feat_dim * self.feat_dtype.itemsize
        self.vertices_per_chunk = max(1, chunk_bytes // max(row_bytes, 1))
        self.read_retries = 2  # straggler/transient-I/O mitigation
        self.retried_chunks = 0

    # ---------------------------------------------------------------- plan
    def chunk_ranges(self) -> list[tuple[int, int]]:
        lo, hi = self.vertex_range
        step = self.vertices_per_chunk
        return [(s, min(s + step, hi)) for s in range(lo, hi, step)]

    def num_chunks(self) -> int:
        return len(self.chunk_ranges())

    # ---------------------------------------------------------------- read
    def _read_chunk(self, index: int, start: int, end: int) -> Chunk:
        ids, feats = self.spills.read_id_range(start, end, self.stats)
        if len(ids) != end - start:
            missing = np.setdiff1d(
                np.arange(start, end, dtype=np.uint64), ids, assume_unique=False
            )
            raise RuntimeError(
                f"chunk [{start},{end}): expected {end - start} rows, got "
                f"{len(ids)} (first missing ids: {missing[:8]})"
            )
        src, dst = self.csr.edges_for_range(start, end)
        # Topology bytes: indptr slice + indices slice, counted logically.
        self.stats.add_read((end - start + 1) * 8 + dst.nbytes)
        return Chunk(
            index=index,
            start_id=start,
            end_id=end,
            ids=ids,
            feats=feats,
            edge_src=np.asarray(src),
            edge_dst=np.asarray(dst),
        )

    def _read_chunk_with_retry(self, index: int, start: int, end: int) -> Chunk:
        """Deterministic chunk retry (straggler/transient-I/O mitigation):
        a chunk read is pure, so re-issuing it is always safe.  Only
        ``OSError`` is retried — anything else (or a persistent ``OSError``)
        re-raises the original error directly."""
        for attempt in range(self.read_retries + 1):
            try:
                return self._read_chunk(index, start, end)
            except OSError:
                if attempt == self.read_retries:
                    raise
                self.retried_chunks += 1
        raise AssertionError("unreachable: retry loop always returns or raises")

    # ------------------------------------------------------------- iterate
    def __iter__(self):
        """Prefetching iterator: dedicated reader thread + bounded queue.

        The stop event lets an abandoning consumer (exception mid-layer,
        generator ``close()``) unblock the worker's ``put`` on the bounded
        queue — without it the reader thread leaks, parked forever on a
        full queue.
        """
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        ranges = self.chunk_ranges()
        error: list[BaseException] = []
        stop = threading.Event()

        def put_checked(item) -> bool:
            """Put unless the consumer has gone away; True on success."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            tr = self.tracer
            try:
                for i, (s, e) in enumerate(ranges):
                    if stop.is_set():
                        return
                    with tr.span("read_chunk", "read"):
                        chunk = self._read_chunk_with_retry(i, s, e)
                    if not put_checked(chunk):
                        return
            except BaseException as exc:  # propagate to consumer
                error.append(exc)
            finally:
                put_checked(None)

        t = threading.Thread(target=worker, name="atlas-reader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            t.join()
            if error:
                raise error[0]
        finally:
            stop.set()
            t.join(timeout=5.0)

    def read_serial(self):
        """Non-threaded variant (deterministic single-thread debugging)."""
        for i, (s, e) in enumerate(self.chunk_ranges()):
            with self.tracer.span("read_chunk", "read"):
                chunk = self._read_chunk(i, s, e)
            yield chunk
