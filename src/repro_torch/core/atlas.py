"""The ATLAS engine: broadcast-based, layer-wise, out-of-core GNN inference
(paper §3).

Pipeline per layer (Fig 3, plus the §4 device pipeline):

    reader thread ──chunks──▶ staging ring ──(k+1 aggregates while k
        │ sequential, single-pass   │          delivers)──▶ this thread
        ▼                           ▼ h2d + aggregate        │ graduated
    sorted spill files       (K1 on cuda / cpu / numpy)      ▼ buffers
    of layer l-1   ◀──writer thread◀── graduation offload thread
                         │                (dense transform, K2)
                         ▼ arena hand-off (io_impl='writeback')
                   write-back I/O thread: sort + serialize,
                   group-commit fsync at the layer barrier

Fault tolerance: a layer is a transaction.  The run manifest records
completed layers and their spill files; a crash mid-layer discards that
layer's partial spills on resume and replays it from the (immutable)
previous layer.  Under the write-back scheduler the layer's spills
become durable at one group-commit barrier at the end of ``run_layer``
— still strictly before the manifest advances, so the crash windows are
unchanged.  When the session shares one scheduler across the run it
passes it in via ``run_layer(scheduler=...)``; the barrier then runs on
a helper thread, overlapped with the next layer's first chunk reads, and
the caller sequences *barrier-wait → manifest advance* through the
returned wait closure — same crash windows, no inter-layer stall.  The
run loop itself lives in ``repro_torch.session.AtlasSession.infer``.

Devices: ``AtlasConfig.backend`` picks where the two accelerator steps
run — ``"cuda"`` (default; raises without a GPU), ``"cpu"`` (the
kernels' plain PyTorch versions), or ``"numpy"`` (the host aggregation
oracle, transform on the CPU).  Delivery, the hot store and eviction stay
host numpy, as in the paper.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

from repro_torch.core.broadcast import chunk_aggregate
from repro_torch.core.eviction import make_policy
from repro_torch.core.graduation import (
    GraduationProcessor,
    LayerTransform,
    make_graduation,
)
from repro_torch.core.memory_manager import MemoryManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.staging import make_aggregation_pipeline
from repro_torch.device import resolve_device
from repro_torch.models.gnn import GNNLayerSpec, edge_weights, self_coefficient
from repro_torch.obs.trace import as_tracer
from repro_torch.storage.coldstore import ColdStore
from repro_torch.storage.io_scheduler import make_scheduler
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.layout import GraphStore
from repro_torch.storage.reader import ChunkReader
from repro_torch.storage.spill import SpillSet
from repro_torch.storage.writer import EmbeddingWriter


@dataclasses.dataclass
class AtlasConfig:
    chunk_bytes: int = 8 * 1024 * 1024  # paper default: 8 MiB chunks
    hot_slots: int | None = None  # explicit slot count, or
    hot_bytes: int | None = 256 * 1024 * 1024  # byte budget -> slots
    eviction: str = "at"  # 'at' | 'lru' | 'rnd'
    num_partitions: int = 8
    spill_buffer_rows: int = 8192
    graduation_rows: int = 8192
    queue_depth: int = 20
    backend: str = "cuda"  # device of aggregation + transform: 'cuda'
    # (kernels K1/K2; raises without a GPU) | 'cpu' (their plain torch
    # versions) | 'numpy' (host aggregation oracle, transform on CPU)
    pipeline: str = "auto"  # chunk staging: 'auto' (staged for device
    # backends when threaded) | 'staged' (ring, aggregate overlaps
    # delivery) | 'serial' (aggregate inline on the delivery thread)
    staging_depth: int = 2  # staging ring depth (chunks in flight)
    policy_impl: str = "array"  # 'array' (vectorized) | 'python' (scalar oracle)
    tail_impl: str = "array"  # layer tail (graduation buffers + spill
    # scatter): 'array' (ring buffers / argsort runs) | 'python' (oracle)
    io_impl: str = "writeback"  # spill durability: 'writeback' (async
    # write-back + one group-commit barrier per layer) | 'sync' (fsync
    # per spill file on the flush path — the bit-identical oracle)
    io_queue_depth: int = 8  # in-flight spill writes behind the scheduler
    threaded: bool = True  # dedicated reader/writer/offload threads
    prefetch_depth: int = 4
    seed: int = 0
    delete_intermediate: bool = True  # drop layer l-1 spills after layer l
    trace: bool = False  # span tracing (repro_torch.obs): per-thread timelines,
    # Perfetto-exportable; the session writes trace.json next to the run
    # manifest.  Zero-cost when False (no-op tracer on every hot path).
    sample_interval_s: float = 0.0  # >0: background RSS/disk sampler
    # (repro_torch.obs.sampler) polling at this interval during session runs


@dataclasses.dataclass
class LayerMetrics:
    layer: int
    seconds: float
    chunks: int
    bytes_read: int
    bytes_written: int
    cold_bytes_read: int
    cold_bytes_written: int
    evictions: int
    reloads: int
    reload_pct_mean: float  # paper Fig 6/7: % of chunk dsts reloaded
    peak_hot_occupancy: int
    peak_cold_resident: int
    graduated: int
    mean_span: float
    p95_span: float
    max_span: int
    # layer-tail busy-time split (paper §3.6-3.7): bookkeeping the
    # array-native tail targets vs the shared transform/disk costs
    tail_seconds: float  # graduation buffering/emit + writer scatter
    transform_seconds: float  # dense layer update (W·x + b + σ)
    spill_seconds: float  # spill cost on the flush path: sort + disk +
    # fsync under io_impl='sync', enqueue/arena-swap under 'writeback'
    tail_rows_per_s: float  # graduated rows / tail_seconds
    # write-back group commit (io_impl='writeback'; zero under 'sync'):
    barrier_seconds: float = 0.0  # the one durability wait per layer
    bytes_inflight: int = 0  # scheduler queue highwater (bytes)
    # device pipeline split: how much of the transfer the
    # staging ring actually hides
    aggregate_seconds: float = 0.0  # time inside aggregate() calls
    h2d_seconds: float = 0.0  # host->device copies (cuda backend, CUDA events)
    pipeline_stall_seconds: float = 0.0  # delivery thread waits on the ring

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _DeferredBarrier:
    """Layer-end group commit on a helper thread: the queue
    drain + fsync pass overlap the next layer's first chunk reads
    instead of serializing between layers.  ``wait`` joins, re-raises
    any barrier error, and fills the layer's metrics — callers sequence
    it strictly *before* the manifest advance, so the crash-consistency
    ordering (data durable -> manifest pointer) is unchanged."""

    def __init__(self, scheduler):
        self._scheduler = scheduler
        self._seconds = 0.0
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="atlas-barrier", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            self._seconds = self._scheduler.barrier()
        except BaseException as e:  # noqa: BLE001 — re-raised in wait()
            self._error = e

    def wait(self, m: "LayerMetrics") -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error
        m.barrier_seconds = self._seconds
        m.bytes_inflight = self._scheduler.qstats.bytes_inflight_peak


# sentinel: distinguishes "make a per-layer scheduler" (legacy/default)
# from an explicitly passed shared scheduler, which may be None (sync)
_OWN_SCHEDULER = object()


class AtlasEngine:
    def __init__(self, config: AtlasConfig | None = None):
        self.config = config or AtlasConfig()

    # ------------------------------------------------------------ helpers
    def _hot_slots(self, hot_width: int, dtype=np.float32) -> int:
        cfg = self.config
        if cfg.hot_slots is not None:
            return cfg.hot_slots
        row_bytes = hot_width * np.dtype(dtype).itemsize
        return max(16, int(cfg.hot_bytes // row_bytes))

    def device(self):
        """The torch device ``config.backend`` runs on; raises
        ``RuntimeError`` for ``'cuda'`` without a GPU."""
        backend = self.config.backend
        if backend == "cuda":
            return resolve_device("cuda")
        if backend in ("cpu", "numpy"):
            return resolve_device("cpu")
        raise ValueError(f"unknown broadcast backend {backend!r}")

    # --------------------------------------------------------------- layer
    def run_layer(
        self,
        csr,
        in_deg: np.ndarray,
        spills: SpillSet,
        spec: GNNLayerSpec,
        out_dir: str,
        layer_index: int = 0,
        scheduler=_OWN_SCHEDULER,
        pending_commit=None,
        tracer=None,
    ):
        """Run one layer.  Default call: makes (and tears down) its own
        write-back scheduler, barriers inline, returns
        ``(SpillSet, LayerMetrics)``.

        Session mode: pass ``scheduler=`` explicitly (the run-shared
        scheduler, or ``None`` under ``io_impl='sync'``) and the return
        becomes ``(SpillSet, LayerMetrics, barrier_wait)`` — the group
        commit runs on a helper thread and ``barrier_wait()`` joins it
        (re-raising errors, filling the barrier metrics); the caller
        must invoke it before recording the layer in the run manifest.
        ``pending_commit`` is the previous layer's commit closure: it is
        called once, after this layer's pipeline has started, so the
        previous barrier overlaps this layer's first chunk reads.
        ``tracer`` (a ``repro_torch.obs.Tracer``) threads span instrumentation
        through every pipeline stage; the ``AtlasConfig.trace`` flag makes
        one when no explicit tracer is passed."""
        cfg = self.config
        device = self.device()  # before any thread starts
        tr = as_tracer(tracer if tracer is not None else cfg.trace)
        # standalone (non-session) callers with cfg.trace=True can export
        # the timeline from here after the call returns
        self.last_tracer = tr
        t0 = time.perf_counter()
        tr.begin(f"layer_{layer_index}", "layer")
        num_vertices = csr.num_vertices

        required = in_deg.astype(np.int64).copy()
        if spec.extra_self_message:
            required += 1
        if np.any(required == 0):
            raise ValueError(
                "vertices with zero required messages would never complete; "
                "GCN needs self-loops in the topology (graphs.csr.add_self_loops)"
            )

        read_stats, write_stats, cold_stats = IOStats(), IOStats(), IOStats()
        reader = ChunkReader(
            csr,
            spills,
            feat_dim=spec.in_dim,
            feat_dtype=np.float32,
            chunk_bytes=cfg.chunk_bytes,
            stats=read_stats,
            prefetch_depth=cfg.prefetch_depth,
            num_vertices=num_vertices,
            tracer=tr,
        )
        orch = Orchestrator(required)
        policy = make_policy(
            cfg.eviction,
            seed=cfg.seed,
            impl=cfg.policy_impl,
            num_vertices=num_vertices,
            max_pending=int(required.max()),
        )
        cold = ColdStore(
            os.path.join(out_dir, "coldstore.bin"),
            dim=spec.hot_width,
            dtype=np.float32,
            initial_slots=max(64, self._hot_slots(spec.hot_width) // 4),
            stats=cold_stats,
        )
        mm = MemoryManager(
            num_slots=self._hot_slots(spec.hot_width),
            dim=spec.hot_width,
            dtype=np.float32,
            orchestrator=orch,
            policy=policy,
            cold=cold,
        )
        # write-back scheduler: spill flushes become enqueue-and-continue;
        # durability collapses into one group-commit barrier at layer end
        # (before the caller's manifest advance).  io_impl='sync' keeps
        # the fsync-per-spill path as the bit-identical oracle.  The
        # session passes one run-shared scheduler in; this method never
        # closes a shared one.
        own_scheduler = scheduler is _OWN_SCHEDULER
        if own_scheduler:
            scheduler = make_scheduler(
                cfg.io_impl, queue_depth=cfg.io_queue_depth, tracer=tr
            )

        def prep(chunk):
            # per-chunk edge prep — runs on the staging thread when the
            # ring pipeline is active (read-only on in_deg/spec)
            src_g = chunk.edge_src.astype(np.int64)
            dst = chunk.edge_dst.astype(np.int64)
            w = edge_weights(spec.kind, src_g, dst, in_deg)
            src_local = (src_g - chunk.start_id).astype(np.int64)
            return src_local, dst, w

        writer = None
        it = None
        try:
            writer = EmbeddingWriter(
                out_dir,
                num_vertices=num_vertices,
                dim=spec.out_dim,
                dtype=np.float32,
                num_partitions=cfg.num_partitions,
                buffer_rows=cfg.spill_buffer_rows,
                stats=write_stats,
                queue_depth=cfg.queue_depth,
                threaded=cfg.threaded,
                ingest_impl=cfg.tail_impl,
                scheduler=scheduler,
                tracer=tr,
            )
            grad = make_graduation(
                cfg.tail_impl,
                transform=LayerTransform(spec, device),
                sink=writer.write,
                dim=spec.hot_width,
                dtype=np.float32,
                buffer_rows=cfg.graduation_rows,
                queue_depth=cfg.queue_depth,
                threaded=cfg.threaded,
                tracer=tr,
            )
            aggregate = chunk_aggregate(cfg.backend)
            if hasattr(aggregate, "tracer"):
                aggregate.tracer = tr  # h2d spans inside the cuda backend
            it = iter(reader) if cfg.threaded else reader.read_serial()
            # staging ring (§4 device pipeline): chunk k+1 preps, stages
            # h2d, and aggregates on a dedicated thread while chunk k is
            # delivered below — FIFO, so delivery order stays the serial
            # index order bit-for-bit
            pipe = make_aggregation_pipeline(
                cfg.pipeline, cfg.backend, cfg.threaded, it, prep,
                aggregate, depth=cfg.staging_depth, tracer=tr,
            )
        except BaseException:
            # a failed constructor (bad tail_impl/backend/pipeline) must
            # not leak the already-spawned offload/io threads or the
            # cold-store fd across retries in a long-lived process
            cleanups = [cold.close]
            if writer is not None:
                cleanups.append(writer.close)
            if it is not None:
                cleanups.append(it.close)
            if scheduler is not None and own_scheduler:
                cleanups.append(
                    lambda: scheduler.close(commit=False, raise_error=False)
                )
            for cleanup in cleanups:
                try:
                    cleanup()
                except BaseException:
                    pass
            tr.end(f"layer_{layer_index}", "layer")
            raise
        self_coef = self_coefficient(spec)
        agg_col = spec.in_dim if spec.kind == "sage" else 0

        reload_fracs: list[float] = []
        chunks = 0
        # reusable eviction shield: one bool per vertex, set/cleared per
        # chunk in O(#destinations) — replaces the per-chunk Python set
        shield = np.zeros(num_vertices, dtype=bool)
        commit_done = pending_commit is None
        try:
            for chunk, (u_dst, partial, counts) in pipe:
                chunks += 1

                # shield everything receiving messages in this chunk
                shield[u_dst] = True
                if spec.extra_self_message:
                    shield[chunk.start_id : chunk.end_id] = True

                n_reload = 0
                if spec.extra_self_message:
                    ids = np.arange(chunk.start_id, chunk.end_id, dtype=np.int64)
                    self_rows = chunk.feats.astype(np.float32) * np.float32(self_coef)
                    n_reload += self._deliver(
                        mm, orch, grad, ids, self_rows,
                        np.ones(len(ids), dtype=np.int64),
                        col_offset=0, shield=shield, chunk_index=chunk.index,
                    )
                if len(u_dst):
                    n_reload += self._deliver(
                        mm, orch, grad, u_dst, partial, counts,
                        col_offset=agg_col, shield=shield, chunk_index=chunk.index,
                    )
                denom = len(u_dst) + (
                    chunk.num_vertices if spec.extra_self_message else 0
                )
                if denom:
                    reload_fracs.append(n_reload / denom)

                shield[u_dst] = False
                if spec.extra_self_message:
                    shield[chunk.start_id : chunk.end_id] = False

                if not commit_done:
                    # overlap point: the previous layer's barrier has been
                    # draining on its helper thread while this layer's
                    # first chunk was read, staged, and delivered — join
                    # it and let the caller advance the manifest now
                    commit_done = True
                    pending_commit()

            if not commit_done:
                commit_done = True
                pending_commit()

            try:
                grad.close()
            finally:
                # always shut the writer thread down, even when graduation
                # re-raises a deferred offload error
                layer_spills = writer.close()

            if not orch.is_complete():
                missing = orch.incomplete_vertices()
                raise RuntimeError(
                    f"layer {layer_index}: {len(missing)} vertices incomplete "
                    f"(first: {missing[:8]})"
                )
            if writer.rows_written != num_vertices:
                raise RuntimeError(
                    f"layer {layer_index}: wrote {writer.rows_written} rows, "
                    f"expected {num_vertices}"
                )

            # the layer's single durability point: drain the write-back
            # queue and group-commit every spill (files + dirs) BEFORE the
            # caller records the layer in the run manifest.  A crash
            # before this point leaves the manifest un-advanced, so
            # resume replays the layer from the previous (durable) one.
            barrier_seconds = 0.0
            bytes_inflight = 0
            barrier_handle = None
            if scheduler is not None:
                if own_scheduler:
                    barrier_seconds = scheduler.barrier()
                    bytes_inflight = scheduler.qstats.bytes_inflight_peak
                    # the explicit barrier above already committed
                    # everything; close() only reclaims the I/O thread
                    scheduler.close(commit=False)
                else:
                    # shared scheduler: the queue must drain *before*
                    # this layer's spill set is handed to the caller —
                    # the next layer streams these files, so they have
                    # to exist (and write errors must surface here, not
                    # after the manifest).  Only the fsync group commit
                    # is deferred to the helper thread, overlapped with
                    # the next layer's first chunk reads.
                    scheduler.drain()
                    barrier_handle = _DeferredBarrier(scheduler)
        except BaseException:
            # a failed layer is discarded and replayed (layer = transaction),
            # but a long-lived process must not leak the offload threads or
            # the cold-store fd across failed attempts: best-effort shutdown
            # without masking the original error (close() is idempotent;
            # the scheduler skips its commit — the partial output is dead).
            # A shared scheduler belongs to the session: never close it here.
            cleanups = [grad.close, writer.close, cold.close]
            if scheduler is not None and own_scheduler:
                cleanups.append(
                    lambda: scheduler.close(commit=False, raise_error=False)
                )
            for cleanup in cleanups:
                try:
                    cleanup()
                except BaseException:
                    pass
            tr.end(f"layer_{layer_index}", "layer")
            raise
        finally:
            # unblock the staging + reader threads if we bail out mid-layer
            pipe.close()

        cold.close()

        tr.end(f"layer_{layer_index}", "layer")
        span = orch.span_stats()
        tail_seconds = grad.tail_seconds + writer.tail_seconds
        m = LayerMetrics(
            layer=layer_index,
            seconds=time.perf_counter() - t0,
            chunks=chunks,
            bytes_read=read_stats.bytes_read,
            bytes_written=write_stats.bytes_written,
            cold_bytes_read=cold_stats.bytes_read,
            cold_bytes_written=cold_stats.bytes_written,
            evictions=mm.eviction_count,
            reloads=mm.reload_count,
            reload_pct_mean=float(np.mean(reload_fracs) * 100) if reload_fracs else 0.0,
            peak_hot_occupancy=mm.peak_occupancy,
            peak_cold_resident=cold.peak_resident,
            graduated=grad.graduated,
            mean_span=span["mean_span"],
            p95_span=span["p95_span"],
            max_span=span["max_span"],
            tail_seconds=tail_seconds,
            transform_seconds=grad.transform_seconds,
            spill_seconds=writer.spill_seconds,
            tail_rows_per_s=grad.graduated / tail_seconds if tail_seconds else 0.0,
            barrier_seconds=barrier_seconds,
            bytes_inflight=bytes_inflight,
            aggregate_seconds=pipe.aggregate_seconds,
            # read through the pipeline (not the local), so the value is
            # pinned to the aggregator the pipeline actually drove and the
            # staged path's read is explicitly ordered after its worker
            # join (see StagedAggregation.h2d_seconds)
            h2d_seconds=pipe.h2d_seconds,
            pipeline_stall_seconds=pipe.stall_seconds,
        )
        if not own_scheduler:
            if barrier_handle is not None:
                barrier_wait = lambda: barrier_handle.wait(m)  # noqa: E731
            else:
                barrier_wait = lambda: None  # noqa: E731 — io_impl='sync'
            return layer_spills, m, barrier_wait
        return layer_spills, m

    # -------------------------------------------------------------- deliver
    @staticmethod
    def _deliver(
        mm: MemoryManager,
        orch: Orchestrator,
        grad: GraduationProcessor,
        vertices: np.ndarray,
        partial: np.ndarray,
        counts: np.ndarray,
        col_offset: int,
        shield: np.ndarray,
        chunk_index: int,
    ) -> int:
        """Route one batch of pre-aggregated records to the hot store.

        Delivery is split into sub-batches of at most ``mm.num_slots``
        destinations: within one activation the sub-batch itself is the
        only hard-unevicatable set, so a sub-batch that fits the hot store
        can always be placed (earlier sub-batches become eviction fodder —
        they will reload, which is exactly the paper's churn the min-pending
        policy then minimises).  ``shield`` is the chunk's soft eviction
        shield as a boolean mask over vertex ids.  Each sub-batch costs one
        activate, one accumulate, one orchestrator deliver, and one batched
        policy update.  Returns the number of COLD->HOT reloads.
        """
        reloads_before = mm.reload_count
        cap = max(1, mm.num_slots)
        for s in range(0, len(vertices), cap):
            vs = vertices[s : s + cap]
            ps = partial[s : s + cap]
            cs = counts[s : s + cap]
            slots = mm.activate(vs, shield)
            mm.accumulate(vs, ps, col_offset, slots=slots)
            done_mask, old_pending, new_pending = orch.deliver(vs, cs, chunk_index)
            live = ~done_mask
            if np.any(live):
                mm.update_policy_scores(vs[live], old_pending[live], new_pending[live])
            if np.any(done_mask):
                # gather finalized rows straight from the hot store into
                # the graduation buffer — no intermediate row array
                mm.release_to(vs[done_mask], grad)
        return mm.reload_count - reloads_before


# --------------------------------------------------------------------------
# Materialisation helper (tests/benchmarks): spills -> dense [V, d] array
# --------------------------------------------------------------------------


def spills_to_dense(spills: SpillSet, num_vertices: int, dim: int) -> np.ndarray:
    out = np.full((num_vertices, dim), np.nan, dtype=np.float32)
    seen = np.zeros(num_vertices, dtype=bool)
    for f in spills.files:
        ids, rows = f.read_all()
        ids = ids.astype(np.int64)
        if np.any(seen[ids]):
            raise RuntimeError("duplicate vertex rows across spill files")
        seen[ids] = True
        out[ids] = rows.astype(np.float32)
    if not np.all(seen):
        raise RuntimeError(f"{int((~seen).sum())} vertices missing from spills")
    return out
