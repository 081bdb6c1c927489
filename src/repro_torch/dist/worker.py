"""Per-shard layer execution: stream own sources, route remote messages.

``run_shard_layer`` is the distributed twin of ``AtlasEngine.run_layer``
for one shard of one layer.  It reuses the single-machine building
blocks unchanged — ``ChunkReader`` (restricted to the shard's source
range), ``Orchestrator`` (required counts zeroed outside the shard's
destination range), ``MemoryManager``/``ColdStore``/eviction policy,
graduation, ``EmbeddingWriter``, and ``AtlasEngine._deliver`` — and adds
the split: per chunk, pre-aggregated records whose destination falls in
this shard deliver immediately; remote destinations accumulate into one
combined bucket per destination shard (one record per *distinct*
destination, partials and counts summed) and post through the exchange
after the stream completes.  The receive phase then delivers every
incoming bucket, at which point the shard's own vertices are complete
and fully graduated.

Bit-identity: on exact-arithmetic graphs every partial sum is exactly
representable, so the local/remote split and the sender-side combine
change only the *order* of additions, never the value — any shard count
reproduces the single-machine spills bitwise.

Devices: ``AtlasConfig.backend`` places the two accelerator steps as in
the engine.  Each shard aggregates its chunks inline on its own thread
(no staging ring) through its own ``chunk_aggregate`` — K1 on its
aggregator's stream on CUDA — and graduates through its own
``LayerTransform`` — K2 on the transform's stream, the layer's weights
uploaded once per shard — so shard threads sharing one card never share
a stream, and every host read of a device result waits on its stream.  Counts are exact always
(each edge counted once), so the orchestrator's over-delivery guard
holds by construction.

Durability is per-shard: each worker owns a ``WritebackIOScheduler``
(``io_impl='writeback'``) and barriers it before reporting DONE — the
coordinator advances the shared run manifest only after *all* shards'
barriers, preserving the data-durable-before-manifest-advance crash
ordering shard-wide.
"""

from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.core.atlas import AtlasConfig, AtlasEngine
from repro_torch.core.broadcast import chunk_aggregate
from repro_torch.core.eviction import make_policy
from repro_torch.core.graduation import LayerTransform, make_graduation
from repro_torch.core.memory_manager import MemoryManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.dist.partition import ShardPlan
from repro_torch.models.gnn import GNNLayerSpec, edge_weights, self_coefficient
from repro_torch.obs.trace import as_tracer
from repro_torch.storage.coldstore import ColdStore
from repro_torch.storage.io_scheduler import make_scheduler
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.reader import ChunkReader
from repro_torch.storage.spill import SpillSet
from repro_torch.storage.writer import EmbeddingWriter


def shard_hot_slots(
    cfg: AtlasConfig, hot_width: int, num_shards: int, dtype=np.float32
) -> int:
    """The shard's slice of the configured hot budget: an explicit
    ``hot_slots`` (or the ``hot_bytes``-derived count) divided evenly
    across shards, so N workers together respect the single-machine
    budget.  Floor of 16 slots, like the engine."""
    if cfg.hot_slots is not None:
        total = cfg.hot_slots
    else:
        row_bytes = hot_width * np.dtype(dtype).itemsize
        total = int(cfg.hot_bytes // row_bytes)
    return max(16, total // max(1, num_shards))


def _merge_by_destination(
    dst_parts: list[np.ndarray],
    row_parts: list[np.ndarray],
    cnt_parts: list[np.ndarray],
    dim: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Combine per-chunk remote records into one record per distinct
    destination (sender-side combine: wire volume = distinct dsts)."""
    dst = np.concatenate(dst_parts)
    rows = np.concatenate(row_parts)
    cnt = np.concatenate(cnt_parts)
    uniq, inv = np.unique(dst, return_inverse=True)
    partial = np.zeros((len(uniq), dim), dtype=np.float32)
    np.add.at(partial, inv, rows)
    counts = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(counts, inv, cnt)
    return uniq, partial, counts


def run_shard_layer(
    csr,
    in_deg: np.ndarray,
    spills: SpillSet,
    spec: GNNLayerSpec,
    out_dir: str,
    layer_index: int,
    shard: int,
    plan: ShardPlan,
    exchange,
    config: AtlasConfig | None = None,
    tracer=None,
    fault=None,
) -> tuple[SpillSet, dict]:
    """Run shard ``shard`` of one layer; returns ``(spills, info)`` where
    ``info`` is a JSON-serializable per-shard report (spill paths, layer
    metrics subset, exchange byte counts).

    ``spills`` must cover at least the shard's source range
    ``plan.range_of(shard)`` of layer ``layer_index`` embeddings (layer 0:
    the store's feature spills; later layers: this shard's own previous
    spills — a shard owns the rows it streams next, so no cross-shard
    file reads happen after layer 0).  ``fault`` is a test hook:
    ``fault(phase)`` is invoked at ``'stream'`` (after the first chunk)
    and ``'post'`` (between post and collect) and may raise to simulate
    a mid-layer worker death.
    """
    cfg = config or AtlasConfig()
    device = AtlasEngine(cfg).device()  # raises for 'cuda' without a GPU
    tr = as_tracer(tracer if tracer is not None else cfg.trace)
    t0 = time.perf_counter()
    num_vertices = csr.num_vertices
    num_shards = plan.num_shards
    lo, hi = plan.range_of(shard)
    tr.begin(f"layer_{layer_index}_s{shard}", "layer")

    required = in_deg.astype(np.int64).copy()
    if spec.extra_self_message:
        required += 1
    if np.any(required[lo:hi] == 0):
        raise ValueError(
            "vertices with zero required messages would never complete; "
            "GCN needs self-loops in the topology (graphs.csr.add_self_loops)"
        )
    # this shard owns destinations [lo, hi) only — everything else is
    # another shard's problem and must not count toward completion here
    required[:lo] = 0
    required[hi:] = 0

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
        vertex_range=(lo, hi),
    )
    orch = Orchestrator(required)
    policy = make_policy(
        cfg.eviction,
        seed=cfg.seed,
        impl=cfg.policy_impl,
        num_vertices=num_vertices,
        max_pending=int(required.max()),
    )
    hot_slots = shard_hot_slots(cfg, spec.hot_width, num_shards)
    cold = ColdStore(
        os.path.join(out_dir, "coldstore.bin"),
        dim=spec.hot_width,
        dtype=np.float32,
        initial_slots=max(64, hot_slots // 4),
        stats=cold_stats,
    )
    mm = MemoryManager(
        num_slots=hot_slots,
        dim=spec.hot_width,
        dtype=np.float32,
        orchestrator=orch,
        policy=policy,
        cold=cold,
        tracer=tr,
    )
    # per-shard write-back scheduler (None under io_impl='sync'): this
    # worker's own durability domain, barriered before DONE is reported
    scheduler = make_scheduler(
        cfg.io_impl, queue_depth=cfg.io_queue_depth, tracer=tr
    )
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
        aggregate.tracer = tr

    self_coef = self_coefficient(spec)
    agg_col = spec.in_dim if spec.kind == "sage" else 0
    shield = np.zeros(num_vertices, dtype=bool)
    # outgoing per-peer accumulators: lists of per-chunk (dst, rows, cnt)
    out_dst = [[] for _ in range(num_shards)]
    out_rows = [[] for _ in range(num_shards)]
    out_cnt = [[] for _ in range(num_shards)]
    chunks = 0
    sent_bytes = recv_bytes = 0
    sent_records = recv_records = 0
    it = iter(reader) if cfg.threaded else reader.read_serial()
    try:
        for chunk in it:
            exchange.check_abort()
            chunks += 1
            src_g = chunk.edge_src.astype(np.int64)
            dst = chunk.edge_dst.astype(np.int64)
            with tr.span("prep", "prep", id=chunk.index):
                w = edge_weights(spec.kind, src_g, dst, in_deg)
                src_local = (src_g - chunk.start_id).astype(np.int64)
            with tr.span("aggregate", "aggregate", id=chunk.index):
                u_dst, partial, counts = aggregate(
                    chunk.feats, src_local, dst, w
                )

            # split by destination owner: local delivers now, remote
            # accumulates into the (src_shard, dst_shard) bucket
            dst_shard = plan.shard_of(u_dst) if len(u_dst) else u_dst
            local_sel = dst_shard == shard
            l_dst = u_dst[local_sel]
            shield[l_dst] = True
            if spec.extra_self_message:
                shield[chunk.start_id : chunk.end_id] = True
                ids = np.arange(chunk.start_id, chunk.end_id, dtype=np.int64)
                self_rows = chunk.feats.astype(np.float32) * np.float32(
                    self_coef
                )
                AtlasEngine._deliver(
                    mm, orch, grad, ids, self_rows,
                    np.ones(len(ids), dtype=np.int64),
                    col_offset=0, shield=shield, chunk_index=chunk.index,
                    tracer=tr,
                )
            if len(l_dst):
                AtlasEngine._deliver(
                    mm, orch, grad, l_dst, partial[local_sel],
                    counts[local_sel],
                    col_offset=agg_col, shield=shield,
                    chunk_index=chunk.index, tracer=tr,
                )
            shield[l_dst] = False
            if spec.extra_self_message:
                shield[chunk.start_id : chunk.end_id] = False
            # boolean-mask selections copy: on CUDA ``partial`` views a
            # pinned block, which must not stay held until the send phase
            for t in np.unique(dst_shard[~local_sel]).tolist():
                sel = dst_shard == t
                out_dst[t].append(u_dst[sel])
                out_rows[t].append(partial[sel])
                out_cnt[t].append(counts[sel])
            if fault is not None and chunks == 1:
                fault("stream")

        # ---- send phase: one combined bucket per remote peer
        buckets = {}
        for t in range(num_shards):
            if t == shard or not out_dst[t]:
                continue
            buckets[t] = _merge_by_destination(
                out_dst[t], out_rows[t], out_cnt[t], spec.in_dim
            )
            sent_records += len(buckets[t][0])
        with tr.span("exchange_post", "sink"):
            sent_bytes = exchange.post(layer_index, shard, buckets)
        if fault is not None:
            fault("post")

        # ---- receive phase: the intra-layer barrier, then deliver
        with tr.span("exchange_collect", "barrier"):
            incoming = exchange.collect(layer_index, shard)
        # deterministic delivery order (by sender) — irrelevant to exact
        # arithmetic, but keeps traces and span stats reproducible
        for src_shard, r_dst, r_rows, r_cnt in sorted(
            incoming, key=lambda b: b[0]
        ):
            r_dst = r_dst.astype(np.int64)
            recv_bytes += int(r_dst.nbytes + r_rows.nbytes + r_cnt.nbytes)
            recv_records += len(r_dst)
            shield[r_dst] = True
            AtlasEngine._deliver(
                mm, orch, grad, r_dst,
                r_rows.astype(np.float32, copy=False),
                r_cnt.astype(np.int64),
                col_offset=agg_col, shield=shield,
                chunk_index=chunks + src_shard, tracer=tr,
            )
            shield[r_dst] = False

        try:
            grad.close()
        finally:
            layer_spills = writer.close()

        if not orch.is_complete():
            missing = orch.incomplete_vertices()
            raise RuntimeError(
                f"layer {layer_index} shard {shard}: {len(missing)} vertices "
                f"incomplete (first: {missing[:8]})"
            )
        if writer.rows_written != hi - lo:
            raise RuntimeError(
                f"layer {layer_index} shard {shard}: wrote "
                f"{writer.rows_written} rows, expected {hi - lo}"
            )
        # the shard's durability point: all spills on disk and fsynced
        # BEFORE this worker reports DONE — the coordinator's manifest
        # advance therefore implies every shard's data is durable
        barrier_seconds = 0.0
        bytes_inflight = 0
        if scheduler is not None:
            barrier_seconds = scheduler.barrier()
            bytes_inflight = scheduler.qstats.bytes_inflight_peak
            scheduler.close(commit=False)
    except BaseException:
        for cleanup in (grad.close, writer.close, cold.close):
            try:
                cleanup()
            except BaseException:
                pass
        if scheduler is not None:
            try:
                scheduler.close(commit=False, raise_error=False)
            except BaseException:
                pass
        tr.end(f"layer_{layer_index}_s{shard}", "layer")
        raise
    finally:
        if hasattr(it, "close"):
            it.close()

    cold.close()
    tr.end(f"layer_{layer_index}_s{shard}", "layer")
    span = orch.span_stats()
    info = {
        "shard": shard,
        "layer": layer_index,
        "rows": hi - lo,
        "spill_paths": [f.path for f in layer_spills.files],
        "seconds": time.perf_counter() - t0,
        "chunks": chunks,
        "bytes_read": read_stats.bytes_read,
        "bytes_written": write_stats.bytes_written,
        "cold_bytes_read": cold_stats.bytes_read,
        "cold_bytes_written": cold_stats.bytes_written,
        "evictions": mm.eviction_count,
        "reloads": mm.reload_count,
        "peak_hot_occupancy": mm.peak_occupancy,
        "graduated": grad.graduated,
        "mean_span": span["mean_span"],
        "max_span": span["max_span"],
        "barrier_seconds": barrier_seconds,
        "bytes_inflight": bytes_inflight,
        "exchange": {
            "sent_bytes": sent_bytes,
            "recv_bytes": recv_bytes,
            "sent_records": sent_records,
            "recv_records": recv_records,
        },
    }
    return layer_spills, info


__all__ = ["run_shard_layer", "shard_hot_slots"]
