"""Low-overhead span tracer with Chrome trace-event / Perfetto export.

ATLAS's pitch is *where time goes* — streaming reads vs aggregation vs
spill vs barrier — and the engine runs those phases on five concurrent
threads (delivery, staging ring, graduation offload, writer, write-back
I/O, plus the per-layer fsync helper).  Scalar accumulators
(``LayerMetrics``) can say how *much* time each phase took but not what
overlapped with what.  The tracer records begin/end span events with
``time.perf_counter_ns`` timestamps and per-thread tracks, so one run
exports a timeline loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Design constraints, in order:

1. **Zero-cost when disabled.**  ``NULL_TRACER`` (a ``NullTracer``) is
   the default everywhere; its ``span()`` returns one shared no-op
   context manager — no allocation, no clock read, no branch in the
   instrumented code.  Hot paths additionally stay un-instrumented below
   the per-batch level (no spans inside per-row loops).
2. **Thread-safe without a hot lock.**  Each thread appends to its own
   event buffer (``threading.local``); the global registry of buffers is
   touched once per thread.  Buffers are assigned small synthetic track
   ids at registration, so short-lived helper threads (the per-layer
   reader / barrier threads) never collide on a recycled OS thread id.
3. **Faithful to the metrics.**  Spans are placed around the *same*
   timed regions that feed ``LayerMetrics`` (aggregate, h2d, deliver,
   tail, spill, fsync, barrier, stall), so per-category span totals
   reconcile with the scalar fields.
4. **On the profiler's clock.**  An enabled tracer also opens a
   ``torch.profiler`` range ``atlas.<category>:<name>`` for each span
   (a ``user_annotation``, as ``record_function`` makes, through the
   ``_record_function_with_args`` pair, which costs the host about a
   tenth of the ``torch.ops.profiler`` pair's dispatch and is not seen
   by dispatch modes), so a ``torch.profiler`` trace of a traced run
   holds the engine's steps beside the kernels and copies.  The profiler
   sees the ranges of the thread that started it, and every thread's
   under ``_ExperimentalConfig(profile_all_threads=True)``.

Span categories used by the engine/serving instrumentation::

    read       chunk reads (reader thread) / serving block fetches
    aggregate  chunk_aggregate() calls (staging or delivery thread)
    h2d        host->device staging inside the CUDA chunk aggregator
               (the pinned fill and the copies' enqueue)
    prep       per-chunk edge prep (weights, local ids)
    deliver    one AtlasEngine._deliver call: its sub-batch loop's own work
    activate   MemoryManager.activate: state lookup, slot bookkeeping,
               zeroing fresh slots
    policy     calls into the eviction policy from the memory manager
               (select_victims, add_many, remove_many, update_many)
    cold       rows moved to (cold_put) and from (cold_take) the cold store
    accumulate the hot-store add of a delivery sub-batch
    orchestrate  Orchestrator.deliver: pending-count bookkeeping
    release    MemoryManager.release_to: the gather to graduation and
               the freeing of slots
    tail       graduation buffering + writer scatter (bookkeeping)
    transform  the dense layer update (W.x + b + sigma)
    sink       hand-off from the graduation thread to the writer queue
    spill      spill serialization: write_spill / submit_spill cost
    fsync      group-commit fsync pass (files + dirs)
    drain      the write-back queue's drain before a layer's spills are
               handed to the next layer (shared scheduler)
    barrier    the layer group commit: queue drain + fsync pass
    stall      waits on a pipeline ring / buffer backpressure
    serve      VertexQueryEngine lookups and cache traffic
    layer      one whole run_layer invocation (the bucketing window)
    gat        a GAT layer step on the device mesh (dist/mesh.py): project,
               score, aggregate, exchange, normalize
    sample     resource-sampler counter track (RSS, disk bytes)

Nesting: ``span()`` is a context manager; spans on one thread must be
strictly nested (guaranteed by ``with`` scoping), which the exporter
preserves as balanced ``B``/``E`` event pairs per track.

Identifiers: ``span``/``begin`` take an optional integer ``id`` (the
engine gives the chunk index), exported as ``args: {"id": ...}``; a span
given none takes the id of the innermost open span on its thread, so one
chunk can be followed across the reader, staging and delivery threads.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch

CATEGORIES = (
    "read", "aggregate", "h2d", "prep", "tail", "transform", "sink",
    "spill", "fsync", "drain", "barrier", "stall", "serve", "layer",
    "sample", "deliver", "activate", "policy", "cold", "accumulate",
    "orchestrate", "release", "gat",
)


class _Span:
    """Context manager for one span; re-usable but not re-entrant."""

    __slots__ = ("_tracer", "_name", "_cat", "_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str, id: int | None):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._id = id

    def __enter__(self) -> "_Span":
        self._tracer.begin(self._name, self._cat, self._id)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.end(self._name, self._cat)
        return False


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op.

    ``enabled`` is False so the few truly hot call sites can branch past
    even the no-op calls; everything else just calls through.
    """

    enabled = False

    def span(self, name: str, cat: str, id: int | None = None) -> _NullSpan:
        return _NULL_SPAN

    def begin(self, name: str, cat: str, id: int | None = None) -> None:
        pass

    def end(self, name: str, cat: str) -> None:
        pass

    def counter(self, name: str, value: float, cat: str = "sample") -> None:
        pass

    @property
    def num_spans(self) -> int:
        return 0

    def events(self) -> list:
        return []

    def spans(self) -> list:
        return []

    def category_seconds(self) -> dict:
        return {}

    def to_chrome(self) -> dict:
        return {"traceEvents": []}

    def export(self, path: str) -> str:
        raise RuntimeError("cannot export a disabled (null) tracer")


NULL_TRACER = NullTracer()


def as_tracer(tracer) -> "Tracer | NullTracer":
    """Normalize ``None``/``False`` to the shared null tracer, ``True``
    to a fresh enabled tracer; pass tracer objects through."""
    if tracer is None or tracer is False:
        return NULL_TRACER
    if tracer is True:
        return Tracer()
    return tracer


class _ThreadBuf:
    """One thread's private event buffer.  ``track`` is a small synthetic
    id assigned at registration — stable even when the OS recycles thread
    idents across short-lived helper threads."""

    __slots__ = ("track", "name", "events", "open")

    def __init__(self, track: int, name: str):
        self.track = track
        self.name = name
        # (ph, ts_ns, name, cat, value) appended lock-free by the owning
        # thread; value is the counter's value on 'C' events, the span's
        # id (or None) on 'B' events, None on 'E' events
        self.events: list[tuple] = []
        # the open spans, innermost last: (profiler range handle, id)
        self.open: list[tuple] = []


class Tracer:
    """Enabled tracer: per-thread event buffers, ns timestamps.

    All methods are safe to call from any thread.  Reading (``events``,
    ``export``...) is intended for after the traced region quiesces; it
    snapshots each buffer without stopping writers.
    """

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bufs: list[_ThreadBuf] = []
        self._next_track = 1
        self._local = threading.local()
        self.t0_ns = time.perf_counter_ns()

    # ---------------------------------------------------------- recording
    def _buf(self) -> _ThreadBuf:
        try:
            return self._local.buf
        except AttributeError:
            t = threading.current_thread()
            with self._lock:
                buf = _ThreadBuf(self._next_track, t.name)
                self._next_track += 1
                self._bufs.append(buf)
            self._local.buf = buf
            return buf

    def span(self, name: str, cat: str, id: int | None = None) -> _Span:
        return _Span(self, name, cat, id)

    def begin(self, name: str, cat: str, id: int | None = None) -> None:
        buf = self._buf()
        if id is None and buf.open:
            id = buf.open[-1][1]
        handle = torch._C._autograd._record_function_with_args_enter(f"atlas.{cat}:{name}")
        buf.open.append((handle, id))
        buf.events.append(("B", time.perf_counter_ns() - self.t0_ns, name, cat, id))

    def end(self, name: str, cat: str) -> None:
        buf = self._buf()
        buf.events.append(("E", time.perf_counter_ns() - self.t0_ns, name, cat, None))
        torch._C._autograd._record_function_with_args_exit(buf.open.pop()[0])

    def counter(self, name: str, value: float, cat: str = "sample") -> None:
        """A counter sample — rendered by Perfetto as a value track
        (the resource sampler's RSS / disk-byte series)."""
        self._buf().events.append(
            ("C", time.perf_counter_ns() - self.t0_ns, name, cat, float(value))
        )

    # ------------------------------------------------------------ reading
    def _snapshot(self) -> list[tuple[int, str, list[tuple]]]:
        with self._lock:
            bufs = list(self._bufs)
        # len() then slice: the owning thread may still be appending, but
        # list.append is atomic and we only read a consistent prefix
        return [(b.track, b.name, b.events[: len(b.events)]) for b in bufs]

    @property
    def num_spans(self) -> int:
        return sum(
            1 for _, _, evs in self._snapshot() for e in evs if e[0] == "B"
        )

    def events(self) -> list[dict]:
        """All events in Chrome trace-event dict form (per-track order is
        append order; tracks are concatenated)."""
        pid = os.getpid()
        out: list[dict] = []
        for track, name, evs in self._snapshot():
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": track,
                "args": {"name": name},
            })
            for ph, ts_ns, ev_name, cat, value in evs:
                rec = {
                    "name": ev_name, "cat": cat, "ph": ph,
                    "ts": ts_ns / 1000.0, "pid": pid, "tid": track,
                }
                if ph == "C":
                    rec["args"] = {"value": value}
                elif ph == "B" and value is not None:
                    rec["args"] = {"id": value}
                out.append(rec)
        return out

    def spans(self) -> list[dict]:
        """Matched (B, E) pairs as span dicts with *self* time: duration
        minus the duration of nested child spans, and the span's ``id``.
        Unclosed spans (a thread still running) are skipped."""
        out: list[dict] = []
        for track, tname, evs in self._snapshot():
            stack: list[list] = []  # [name, cat, ts, child_ns, id]
            for ph, ts_ns, name, cat, value in evs:
                if ph == "B":
                    stack.append([name, cat, ts_ns, 0, value])
                elif ph == "E" and stack:
                    b_name, b_cat, b_ts, child, b_id = stack.pop()
                    dur = ts_ns - b_ts
                    if stack:
                        stack[-1][3] += dur
                    out.append({
                        "tid": track, "thread": tname,
                        "name": b_name, "cat": b_cat, "id": b_id,
                        "start_s": b_ts / 1e9, "dur_s": dur / 1e9,
                        "self_s": max(0, dur - child) / 1e9,
                    })
        return out

    def category_seconds(self) -> dict[str, float]:
        """Per-category *self* time totals across all tracks — the scalar
        view the obs_report reconciles against ``LayerMetrics``."""
        totals: dict[str, float] = {}
        for sp in self.spans():
            totals[sp["cat"]] = totals.get(sp["cat"], 0.0) + sp["self_s"]
        return totals

    # ------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace-event JSON (Perfetto-loadable)
        atomically; returns ``path``."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path


def merge_trace_files(paths: list[str], out_path: str) -> str:
    """Merge several exported trace files into one timeline.

    Used by the process-mode distributed runner: each shard worker
    exports its own trace; the merge remaps every input file onto a
    distinct synthetic pid (1, 2, ...) — per-layer subprocesses of the
    same shard reuse OS pids, so the real pid cannot be the track key —
    and labels it with a ``process_name`` metadata record derived from
    the filename.  Event timestamps are kept as-is: every worker's
    tracer starts its clock at process start, so tracks align at t=0 per
    (shard, layer) rather than on one global clock — good enough for the
    within-layer phase breakdown the dist smoke checks."""
    merged: list[dict] = []
    for i, path in enumerate(sorted(paths)):
        with open(path) as f:
            data = json.load(f)
        pid = i + 1
        label = os.path.splitext(os.path.basename(path))[0]
        merged.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        for ev in data.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            merged.append(ev)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, out_path)
    return out_path


__all__ = [
    "CATEGORIES",
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "as_tracer",
    "merge_trace_files",
]
