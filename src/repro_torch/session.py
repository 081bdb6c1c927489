"""`AtlasSession`: the run → publish → query lifecycle behind one API.

    with AtlasSession(store, config=cfg) as session:
        result = session.infer(specs)            # typed RunResult
        session.publish(result.final)            # epoch-numbered version
        with session.reader(result.final.layer) as reader:
            rows = reader.lookup(vertex_ids)     # pinned to that version

``infer`` runs layer-wise out-of-core inference (paper §3) on the device
``AtlasConfig.backend`` names; ``publish``/``reader``/``gc`` are host
code over numpy and mmaps.  Every on-disk format — the run manifest,
version directories, servable files, the store manifest's
``servable_layers`` entry, lease files and the store lock — is the one
the JAX package writes, so stores, versions and pins are interchangeable
between the two packages.

Versioning (MVCC): every ``publish`` compacts into a fresh
``servable_l<L>/v<epoch>/`` directory and swaps the store manifest's
current-version pointer atomically; version directories are immutable.
``reader`` pins (refcounts) the version current at open time, so a
concurrent re-publish never changes or deletes rows under a live reader;
unpinned stale versions are garbage-collected on the next publish —
all of them by default, or all but the newest ``retain=N`` historical
ones (pinned versions never count against the budget).

Pins are visible **across processes**: besides the in-process refcount,
every reader drops a heartbeated lease file under its pinned version
directory (``repro_torch.serve_gnn.leases``), and ``publish``/``gc``
honor any version with a live lease exactly like a local pin — so
several serving processes can read one store while one session
publishes and collects.  A lease whose process died is reaped after its
TTL; readers dropped without ``close()`` are backstopped by a
``weakref`` finalizer.  Run one *publishing* session per store; open as
many reading sessions as needed.

Durability: with ``AtlasConfig.io_impl="writeback"`` (default) the
session owns one write-back I/O scheduler; publishes stream staged files
through it and group-commit them (one barrier: files + dirs fsynced)
strictly before the version rename and manifest swap, and the engine
barriers each layer before ``infer`` records it in the run manifest —
so every crash window resolves to "manifest un-advanced, replay/retry".

The run side is resumable: ``infer`` records completed layers in a
schema-versioned ``run_manifest.json`` (``RunManifest``); ``resume=True``
validates the manifest's schema, store identity, and spill files before
touching anything, failing with a clear ``StaleManifestError`` instead of
a raw ``FileNotFoundError`` mid-resume.

``AtlasEngine.run`` and ``GraphStore.register_servable_layer`` survive as
thin deprecation shims over this API.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import threading
import time
import weakref

from repro_torch.core.atlas import AtlasConfig, AtlasEngine, LayerMetrics
from repro_torch.graphs.csr import degrees_from_csr
from repro_torch.models.gnn import GNNLayerSpec, require_static_weights
from repro_torch.obs.sampler import ResourceSampler
from repro_torch.obs.trace import as_tracer
from repro_torch.serve_gnn.leases import (
    DEFAULT_LEASE_TTL,
    PinLease,
    live_leases,
    store_lock,
)
from repro_torch.serve_gnn.page_cache import ShardedPageCache
from repro_torch.serve_gnn.query import VertexQueryEngine
from repro_torch.serve_gnn.servable import ServableLayer
from repro_torch.storage.io_scheduler import make_scheduler
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.layout import GraphStore
from repro_torch.storage.spill import DEFAULT_BLOCK_ROWS, SpillFile, SpillSet

RUN_MANIFEST_SCHEMA_VERSION = 3


class StaleManifestError(RuntimeError):
    """A run manifest that cannot be resumed: wrong schema version, a
    different store (vertex count or ordering/permutation digest), or
    spill files that no longer exist."""


# --------------------------------------------------------------------------
# Typed run manifest (replaces the raw run_manifest.json dict)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RunManifest:
    """Schema-versioned record of one inference run's progress.

    A layer is a transaction: ``completed_layers`` and the completed
    layers' spill paths are only advanced after the layer's spills are
    fully on disk, so a crash mid-layer resumes from the previous one.
    """

    num_vertices: int
    num_layers: int  # len(specs) of the run this manifest belongs to
    layer_dims: list[int] = dataclasses.field(default_factory=list)  # out_dim per spec
    completed_layers: int = 0
    spills: dict[int, list[str]] = dataclasses.field(default_factory=dict)
    # the store's vertex ID namespace at run time: spill ids are internal
    # (storage-order) ids, so a resumed run must see the same permutation
    store_ordering: str = "original"
    store_digest: str = ""
    schema_version: int = RUN_MANIFEST_SCHEMA_VERSION

    def save(self, path: str, scheduler=None) -> None:
        payload = {
            "schema_version": self.schema_version,
            "num_vertices": self.num_vertices,
            "num_layers": self.num_layers,
            "layer_dims": list(self.layer_dims),
            "completed_layers": self.completed_layers,
            "spills": {str(k): v for k, v in self.spills.items()},
            "store_ordering": self.store_ordering,
            "store_digest": self.store_digest,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)
        if scheduler is not None:
            # manifest durability rides the write-back scheduler's next
            # group-commit barrier (the following layer's, or the final
            # one in ``infer``) instead of an inline fsync; the advance
            # itself still happens strictly after the layer's data
            # barrier, so the crash ordering is unchanged
            scheduler.note_dirty(path)

    @staticmethod
    def load(path: str) -> "RunManifest":
        try:
            with open(path) as f:
                data = json.load(f)
        except ValueError as e:  # includes json.JSONDecodeError
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (not valid JSON: {e})"
            ) from e
        ver = data.get("schema_version") if isinstance(data, dict) else None
        if ver != RUN_MANIFEST_SCHEMA_VERSION:
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (schema_version={ver!r}, "
                f"this build writes {RUN_MANIFEST_SCHEMA_VERSION}); delete the "
                f"workdir or rerun without resume"
            )
        try:
            return RunManifest(
                num_vertices=int(data["num_vertices"]),
                num_layers=int(data["num_layers"]),
                layer_dims=[int(d) for d in data["layer_dims"]],
                completed_layers=int(data["completed_layers"]),
                spills={
                    int(k): list(v) for k, v in data.get("spills", {}).items()
                },
                store_ordering=str(data["store_ordering"]),
                store_digest=str(data["store_digest"]),
                schema_version=int(ver),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (malformed field: {e!r})"
            ) from e

    def validate_resume(
        self,
        path: str,
        num_vertices: int,
        layer_dims: list[int],
        store_ordering: str | None = None,
        store_digest: str | None = None,
    ) -> None:
        """Fail fast — before any layer work — if this manifest does not
        belong to (store, specs), the store's vertex namespace changed
        under it, or its recorded spill files are gone."""
        if self.num_vertices != num_vertices:
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (records "
                f"{self.num_vertices} vertices, store has {num_vertices})"
            )
        if store_digest is not None and self.store_digest != store_digest:
            # spill ids are internal ids under the recorded permutation —
            # replaying them against a reordered store would silently
            # serve every row under the wrong vertex
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (permutation digest "
                f"mismatch: run recorded ordering "
                f"{self.store_ordering!r} digest {self.store_digest}, store "
                f"now has {store_ordering!r} digest {store_digest}; the "
                f"store was rebuilt under a different vertex order — delete "
                f"the workdir or rerun without resume)"
            )
        if self.layer_dims != list(layer_dims):
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (records layer dims "
                f"{self.layer_dims}, this run's specs have {list(layer_dims)})"
            )
        if self.completed_layers > self.num_layers:
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest ({self.completed_layers} "
                f"completed layers, run has only {self.num_layers})"
            )
        if not self.completed_layers:
            return
        paths = self.spills.get(self.completed_layers)
        if not paths:
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest (no spill files recorded "
                f"for completed layer {self.completed_layers})"
            )
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise StaleManifestError(
                f"{path}: stale/foreign run manifest — {len(missing)} of "
                f"{len(paths)} spill files for layer {self.completed_layers} "
                f"are missing: {missing}"
            )


# --------------------------------------------------------------------------
# Typed run results
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerHandle:
    """One layer's on-disk embeddings as produced by the engine."""

    layer: int  # 1-based output layer number (layer l = output of spec l-1)
    spills: SpillSet
    num_rows: int
    dim: int


@dataclasses.dataclass
class RunResult:
    """What ``AtlasSession.infer`` returns: the typed manifest, per-layer
    metrics for the layers run in this call, and handles to every layer
    whose spills are still on disk (just the final one unless
    ``AtlasConfig.delete_intermediate`` is off)."""

    manifest: RunManifest
    metrics: list[LayerMetrics]
    layers: dict[int, LayerHandle]
    # run-wide observability: the shared write-back scheduler's
    # final QueueStats snapshot (None under io_impl='sync'), the unified
    # telemetry tree (layers + io queue + trace category totals +
    # resource gauges; None when nothing was collected), and the path of
    # the exported Perfetto trace (None when tracing was off)
    queue_stats: dict | None = None
    telemetry: dict | None = None
    trace_path: str | None = None

    @property
    def final(self) -> LayerHandle:
        return self.layers[max(self.layers)]


@dataclasses.dataclass(frozen=True)
class PublishedVersion:
    """One immutable published servable version of one layer."""

    layer: int
    epoch: int
    dir: str
    files: list[str]
    num_rows: int
    dim: int
    gc_removed: tuple[int, ...] = ()  # stale epochs collected by this publish


# --------------------------------------------------------------------------
# Pinned readers
# --------------------------------------------------------------------------


def _finalize_reader(session: "AtlasSession", layer: int, epoch: int, lease):
    """Backstop for a reader dropped without ``close()`` (a crashed
    worker thread, a leaked reference): runs when the garbage collector
    reclaims the reader.  The cross-process lease is released inline
    (file ops only), but the in-process unpin is *queued* — a finalizer
    can fire mid-allocation on a thread that already holds the session
    lock, so taking it here could deadlock.  The queue drains at the
    session's next lock acquisition (``reader``/``publish``/``gc``/
    ``close``)."""
    if lease is not None:
        lease.release(join=False)
    session._pending_unpins.append((layer, epoch))


class SessionReader(VertexQueryEngine):
    """A ``VertexQueryEngine`` pinned to one published version.

    The pin — an in-process refcount plus an on-disk heartbeated lease
    visible to other processes — keeps the version's files on disk
    across re-publishes; ``close`` releases both, after which the
    version is collectable on the next publish.  Use as a context
    manager; a reader dropped without ``close()`` is unpinned by a
    ``weakref`` finalizer when the garbage collector reclaims it, so a
    leaked reader can never pin a version forever.

    Lookups take **external** (original) vertex ids: when the store was
    built with a non-identity ordering the session passes the mmapped
    ``new_of_old`` sidecar as ``id_map`` and every request is translated
    to internal storage ids up front — so the same caller ids return the
    same rows no matter how the store is physically laid out.
    """

    def __init__(
        self,
        session: "AtlasSession",
        layer_index: int,
        epoch: int,
        servable: ServableLayer,
        cache: ShardedPageCache | None = None,
        stats: IOStats | None = None,
        tracer=None,
        id_map=None,
        id_unmap=None,
        lease: PinLease | None = None,
        fast_path: bool = False,
    ):
        super().__init__(
            servable, cache=cache, stats=stats, tracer=tracer,
            id_map=id_map, id_unmap=id_unmap, fast_path=fast_path,
        )
        self._session = session
        self.layer_index = layer_index
        self.version = epoch
        self._lease = lease
        self._closed = False
        self._finalizer = weakref.finalize(
            self, _finalize_reader, session, layer_index, epoch, lease
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._finalizer.detach()  # this close supersedes the GC backstop
        self.layer.close()  # drop id-column/row mmaps
        if self._lease is not None:
            self._lease.release()
        self._session._release(self.layer_index, self.version)

    def __enter__(self) -> "SessionReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# The session
# --------------------------------------------------------------------------


class AtlasSession:
    """Owns one store's inference workdir and serving versions.

    ``store`` is a ``GraphStore`` or a store root path.  ``workdir``
    (default ``<store.root>/run``) holds the run manifest and per-layer
    spill directories.  Pass ``engine`` to reuse a configured (or
    subclassed) ``AtlasEngine``; otherwise one is built from ``config``.
    """

    def __init__(
        self,
        store: GraphStore | str,
        config: AtlasConfig | None = None,
        workdir: str | None = None,
        engine: AtlasEngine | None = None,
        trace=None,
        clock=None,
        lease_ttl: float = DEFAULT_LEASE_TTL,
    ):
        self.store = GraphStore.open(store) if isinstance(store, str) else store
        self.engine = engine if engine is not None else AtlasEngine(config)
        self.workdir = workdir or os.path.join(self.store.root, "run")
        # injectable time source (epoch seconds): publish timestamps and
        # the retain_ttl retention clock — tests pin it
        self._clock = clock if clock is not None else time.time
        # cross-process pin leases: readers heartbeat at lease_ttl/4;
        # gc treats a lease as stale (reapable) once its mtime is older
        # than lease_ttl AND its pid is dead
        self._lease_ttl = float(lease_ttl)
        # trace: None defers to AtlasConfig.trace; True/False overrides
        # it; a Tracer instance is used directly (one timeline can span
        # several sessions/runs)
        if trace is None:
            trace = self.engine.config.trace
        self.tracer = as_tracer(trace)
        self._lock = threading.Lock()  # pins + manifest reads + GC
        self._publish_lock = threading.Lock()  # serializes publishes
        self._pins: dict[tuple[int, int], int] = {}  # (layer, epoch) -> count
        # weak refs: a strong list would keep dropped readers alive and
        # their finalizer backstop could never fire
        self._readers: list[weakref.ref] = []
        # (layer, epoch) pins released by reader finalizers, applied at
        # the next lock acquisition (deque.append is atomic + lock-free)
        self._pending_unpins: collections.deque = collections.deque()
        self._published_layers: set[int] = set()
        self._last_result: RunResult | None = None
        self._session_closed = False
        self._io_sched = None  # the write-back scheduler (runs + publishes)

    def _run_scheduler(self):
        """The session's write-back scheduler (None when the engine
        config runs ``io_impl='sync'``).  One instance serves every layer
        of an ``infer`` run and every publish, so queue depth and fsync
        accounting (``QueueStats``) are global across layers.  Created
        lazily, recreated after an error retired it; ``close`` tears it
        down."""
        if self.engine.config.io_impl == "sync":
            return None
        if self._io_sched is None or self._io_sched.closed:
            self._io_sched = make_scheduler(
                self.engine.config.io_impl,
                queue_depth=self.engine.config.io_queue_depth,
                tracer=self.tracer,
            )
        return self._io_sched

    # ------------------------------------------------------------ context
    def __enter__(self) -> "AtlasSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _drain_finalized(self) -> None:
        """Apply pins queued by reader finalizers (see
        ``_finalize_reader``) — called before every pin/GC decision."""
        while True:
            try:
                layer, epoch = self._pending_unpins.popleft()
            except IndexError:
                return
            self._release(layer, epoch)

    def close(self) -> None:
        """Close any still-open readers and collect stale versions of the
        layers this session published.  Further ``reader`` calls raise."""
        self._drain_finalized()
        with self._lock:
            self._session_closed = True
            refs, self._readers = self._readers, []
        for ref in refs:
            r = ref()
            if r is not None:
                r.close()
        for layer in sorted(self._published_layers):
            self.gc(layer)
        if self._io_sched is not None:
            # publishes barrier before returning, so this drains an idle
            # queue — it only reclaims the I/O thread
            self._io_sched.close(raise_error=False)
            self._io_sched = None

    @property
    def run_manifest_path(self) -> str:
        return os.path.join(self.workdir, "run_manifest.json")

    # -------------------------------------------------------------- infer
    def infer(
        self, specs: list[GNNLayerSpec], resume: bool = False
    ) -> RunResult:
        """Run layer-wise out-of-core inference; returns a typed
        ``RunResult``.  With ``resume=True`` a valid run manifest in the
        workdir restarts from the first incomplete layer (a layer is a
        transaction); an unusable manifest raises ``StaleManifestError``
        before any work happens."""
        store = self.store
        for spec in specs:
            require_static_weights(spec)
        self.engine.device()  # no GPU for backend='cuda': raise before any work
        os.makedirs(self.workdir, exist_ok=True)
        manifest_path = self.run_manifest_path
        dims = [int(spec.out_dim) for spec in specs]
        manifest = RunManifest(
            num_vertices=store.num_vertices,
            num_layers=len(specs),
            layer_dims=dims,
            store_ordering=store.ordering_name,
            store_digest=store.ordering_digest,
        )
        if resume and os.path.exists(manifest_path):
            manifest = RunManifest.load(manifest_path)
            manifest.validate_resume(
                manifest_path,
                store.num_vertices,
                dims,
                store_ordering=store.ordering_name,
                store_digest=store.ordering_digest,
            )

        csr = store.topology()
        in_deg, _ = degrees_from_csr(csr)
        metrics: list[LayerMetrics] = []
        layers: dict[int, LayerHandle] = {}
        spills = store.layer0_spills()
        done = manifest.completed_layers
        if done:
            # every completed layer whose spills survive on disk gets a
            # handle (earlier ones are usually gone under
            # delete_intermediate, but a keep-everything run can publish
            # them after resuming)
            for k in sorted(k for k in manifest.spills if k <= done):
                paths = manifest.spills[k]
                if k < done and not all(os.path.exists(p) for p in paths):
                    continue
                ss = SpillSet()
                for p in paths:
                    ss.add(SpillFile.open(p))
                layers[k] = self._handle(k, ss, specs[k - 1].out_dim)
            spills = layers[done].spills

        cfg = self.engine.config
        # one write-back scheduler for the whole run: queue depth, arena
        # pool, and QueueStats are global across layers instead of
        # fragmented per run_layer.  Reclaimed at the end of the run —
        # every layer has already group-committed by then, so the close
        # below only stops the I/O thread.
        scheduler = self._run_scheduler() if done < len(specs) else None
        pending_commit = None
        queue_stats: dict | None = None
        sampler = None
        if cfg.sample_interval_s > 0:
            sampler = ResourceSampler(
                interval_s=cfg.sample_interval_s, tracer=self.tracer
            ).start()
        try:
            for l in range(done, len(specs)):
                # discard partial output of a crashed attempt at this layer
                out_dir = os.path.join(self.workdir, f"layer_{l + 1}")
                if os.path.exists(out_dir):
                    shutil.rmtree(out_dir)
                # the previous layer's commit (barrier-wait -> manifest
                # advance -> spill GC) rides into run_layer, which calls
                # it after its own pipeline has started — the group
                # commit overlaps this layer's first chunk reads
                layer_spills, m, barrier_wait = self.engine.run_layer(
                    csr, in_deg, spills, specs[l], out_dir, layer_index=l,
                    scheduler=scheduler, pending_commit=pending_commit,
                    tracer=self.tracer,
                )
                metrics.append(m)
                pending_commit = self._layer_commit(
                    manifest, manifest_path, l, layer_spills, barrier_wait,
                    spills, layers, scheduler,
                )
                spills = layer_spills
                layers[l + 1] = self._handle(
                    l + 1, layer_spills, specs[l].out_dim
                )
            if pending_commit is not None:
                pending_commit()
            if scheduler is not None:
                # the final manifest write deferred its fsync to the next
                # group commit — this is it
                scheduler.barrier()
                # the run-wide I/O accounting, captured at its final
                # (post-last-barrier, pre-close) state — the close below
                # only reclaims the I/O thread
                queue_stats = scheduler.qstats.snapshot()
                scheduler.close(commit=False)
                self._io_sched = None
        except BaseException:
            # the last *finished* layer's commit may still be pending
            # (its data is complete; only barrier+manifest were deferred)
            # — attempt it so resume restarts after it, but never mask
            # the original error.  The closure is idempotent, so a commit
            # that already ran (or already failed) inside run_layer is a
            # no-op here.
            if pending_commit is not None:
                try:
                    pending_commit()
                except BaseException:
                    pass
            # retire the run-shared scheduler: a sticky I/O error must
            # not poison later publishes; the lazy getter recreates it
            if scheduler is not None:
                scheduler.close(commit=False, raise_error=False)
                self._io_sched = None
            raise
        finally:
            if sampler is not None:
                sampler.stop()

        if not layers:  # zero specs: the "final" layer is the input itself
            layers[0] = self._handle(0, spills, store.feat_dim)
        result = RunResult(
            manifest=manifest, metrics=metrics, layers=layers,
            queue_stats=queue_stats,
        )
        result.telemetry = self._telemetry(metrics, queue_stats, sampler)
        if self.tracer.enabled:
            result.trace_path = self.tracer.export(
                os.path.join(self.workdir, "trace.json")
            )
        self._last_result = result
        return result

    def _telemetry(self, metrics, queue_stats, sampler) -> dict | None:
        """One nested snapshot of everything this run measured; ``None``
        when neither tracing, the sampler, nor the scheduler ran."""
        tree: dict = {}
        if metrics:
            tree["layers"] = [m.as_dict() for m in metrics]
        if queue_stats is not None:
            tree["io_queue"] = queue_stats
        if self.tracer.enabled:
            tree["trace"] = {
                "num_spans": self.tracer.num_spans,
                "category_seconds": self.tracer.category_seconds(),
            }
        if sampler is not None:
            tree["resources"] = sampler.snapshot()
        return tree or None

    def _layer_commit(
        self, manifest, manifest_path, l, layer_spills, barrier_wait,
        prev_spills, layers, scheduler=None,
    ):
        """Build layer ``l``'s deferred commit closure: join the
        overlapped group commit, then advance the manifest, then drop the
        layer's *input* spills.  The ordering is load-bearing twice over:
        the barrier completes strictly before the manifest records the
        layer (data durable -> manifest advance, the write-back crash window),
        and the manifest is saved strictly before the previous spills are
        deleted (a crash in between resumes from the new layer; the
        reverse would leave the manifest pointing at deleted files).
        Idempotent — ``infer`` may retry it on its error path after
        ``run_layer`` already ran it."""
        cfg = self.engine.config
        state = {"attempted": False}

        def commit() -> None:
            if state["attempted"]:
                return
            state["attempted"] = True
            barrier_wait()
            manifest.completed_layers = l + 1
            manifest.spills[l + 1] = [f.path for f in layer_spills.files]
            manifest.save(
                manifest_path,
                scheduler=scheduler if scheduler is not None
                and not scheduler.closed else None,
            )
            if cfg.delete_intermediate and l > 0:
                prev_spills.delete_all()
                layers.pop(l, None)

        return commit

    @staticmethod
    def _handle(layer: int, spills: SpillSet, dim: int) -> LayerHandle:
        return LayerHandle(
            layer=layer, spills=spills, num_rows=spills.total_rows(), dim=dim
        )

    # ------------------------------------------------------------ publish
    def publish(
        self,
        layer: LayerHandle | int,
        spills: SpillSet | None = None,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        rows_per_file: int | None = None,
        stats: IOStats | None = None,
        retain: int = 0,
        retain_ttl: float | None = None,
    ) -> PublishedVersion:
        """Compact one layer's spills into a new epoch-numbered servable
        version and atomically swap the store's current-version pointer.
        ``layer`` is a ``LayerHandle`` (e.g. ``result.final``), or a layer
        number — resolved against ``spills`` when given, else against the
        session's last ``infer`` result.

        Retention: at most ``retain`` *unpinned* historical (non-current)
        versions survive this publish — the newest ones; additionally any
        unpinned version younger than ``retain_ttl`` seconds (against its
        recorded ``published_at`` timestamp) survives.  The rest are
        garbage-collected before returning.  Versions pinned by an open
        reader always survive and do not count against either budget.
        The default ``retain=0, retain_ttl=None`` keeps the original
        collect-everything-stale behavior."""
        handle = self._resolve(layer, spills)
        self._drain_finalized()
        with self._publish_lock:
            scheduler = self._run_scheduler()
            try:
                info = self.store.publish_servable_layer(
                    handle.layer,
                    handle.spills,
                    block_rows=block_rows,
                    rows_per_file=rows_per_file,
                    stats=stats,
                    scheduler=scheduler,
                    published_at=self._clock(),
                )
            except BaseException:
                # a failed publish may leave the scheduler with a sticky
                # I/O error: retire it (skip its commit — the staged
                # version is dead) so a retry starts clean
                if scheduler is not None:
                    scheduler.close(commit=False, raise_error=False)
                    self._io_sched = None
                raise
            self._published_layers.add(handle.layer)
            removed = self._gc_locked(
                handle.layer, retain=retain, retain_ttl=retain_ttl
            )
        return PublishedVersion(
            layer=handle.layer,
            epoch=info["epoch"],
            dir=info["dir"],
            files=list(info["files"]),
            num_rows=info["num_rows"],
            dim=info["dim"],
            gc_removed=tuple(removed),
        )

    def _resolve(
        self, layer: LayerHandle | int, spills: SpillSet | None
    ) -> LayerHandle:
        if isinstance(layer, LayerHandle):
            if spills is not None:
                raise ValueError("pass a LayerHandle or (layer, spills), not both")
            return layer
        layer = int(layer)
        if spills is not None:
            if not spills.files:
                raise ValueError("cannot publish an empty spill set")
            return self._handle(layer, spills, spills.files[0].dim)
        if self._last_result is None or layer not in self._last_result.layers:
            have = (
                sorted(self._last_result.layers) if self._last_result else []
            )
            raise KeyError(
                f"layer {layer} has no spills in this session's last run "
                f"(have: {have}); pass spills= or a LayerHandle"
            )
        return self._last_result.layers[layer]

    def gc(
        self, layer: int, retain: int = 0, retain_ttl: float | None = None
    ) -> list[int]:
        """Drop stale (non-current) versions of ``layer`` that no open
        reader pins, keeping the newest ``retain`` unpinned ones and any
        unpinned version younger than ``retain_ttl`` seconds.
        Returns the collected epoch numbers."""
        self._drain_finalized()
        with self._publish_lock:  # never concurrent with a manifest write
            return self._gc_locked(layer, retain=retain, retain_ttl=retain_ttl)

    def _gc_locked(
        self, layer: int, retain: int = 0, retain_ttl: float | None = None
    ) -> list[int]:
        """GC body; caller holds ``_publish_lock``.

        The retirement *decision* runs under the cross-process store
        lock: stale leases are reaped, and any version with a surviving
        lease — a reader pinned in another process — is skipped exactly
        like a locally pinned one.  Only the manifest retirement happens
        under the locks; the (potentially large) file deletion runs
        after both are released, so concurrent ``reader`` opens never
        stall on disk I/O."""
        retain = max(0, int(retain))
        now = self._clock() if retain_ttl is not None else None
        with store_lock(self.store.root), self._lock:
            try:
                current = self.store.current_servable_epoch(layer)
            except KeyError:
                return []
            retired: list[tuple[int, dict]] = []
            kept_unpinned = 0
            # newest-first, so the `retain` most recent unpinned
            # historical versions survive and everything older goes
            for epoch in sorted(self.store.servable_versions(layer), reverse=True):
                if epoch == current or self._pins.get((layer, epoch)):
                    continue
                info_v = self.store.servable_version_info(layer, epoch)
                # cross-process pins: reap dead readers' stale leases,
                # honor every surviving one (never counts against the
                # retain budget, mirroring local pins)
                if live_leases(info_v["dir"], ttl=self._lease_ttl):
                    continue
                if kept_unpinned < retain:
                    kept_unpinned += 1
                    continue
                if retain_ttl is not None:
                    # versions predating publish timestamps (no
                    # published_at recorded) count as infinitely old
                    published_at = info_v.get("published_at")
                    if (
                        published_at is not None
                        and now - float(published_at) < retain_ttl
                    ):
                        continue
                info = self.store.drop_servable_version(
                    layer, epoch, delete_files=False
                )
                retired.append((epoch, info))
        for _, info in retired:
            self.store.delete_servable_files(layer, info)
        return [e for e, _ in retired]

    # ------------------------------------------------------------- reader
    def reader(
        self,
        layer: int,
        epoch: int | None = None,
        cache: ShardedPageCache | None = None,
        cache_bytes: int | None = None,
        num_shards: int = 4,
        stats: IOStats | None = None,
        fast_path: bool | str = "auto",
        metrics=None,
    ) -> SessionReader:
        """A query engine pinned to the version of ``layer`` current at
        this call (or an explicit still-on-disk ``epoch``).  The pinned
        version survives re-publishes — by any process — until the
        reader is closed.  Lookups take external (original) vertex ids;
        reordered stores translate through their permutation sidecar
        transparently.

        ``fast_path`` selects the zero-copy mmap serving path: ``True``
        gathers rows straight from the version's file mmaps (the OS page
        cache is the cache — no ``ShardedPageCache``), ``False`` forces
        the decoded-block page-cache path (the bit-identity oracle), and
        ``"auto"`` (default) picks the mmap path when the version's data
        fits the ``cache_bytes`` budget and no explicit ``cache`` was
        passed — the whole working set would be cache-resident anyway,
        so serving the mapping directly skips the decode + copy.

        ``cache_bytes`` builds a fresh per-reader ``ShardedPageCache``;
        pass ``cache`` only to share one across readers of the *same*
        version — block keys are per-version, so a cache must never
        outlive the version it was filled from.  ``metrics`` (an
        ``obs.MetricsRegistry``) exports the cache's hit/miss/eviction
        counters and resident gauges under ``serve.cache.*``."""
        layer = int(layer)
        if fast_path is True and cache is not None:
            raise ValueError(
                "fast_path=True serves from file mmaps and never consults "
                "a page cache; pass cache/cache_bytes or fast_path, not both"
            )
        self._drain_finalized()
        # pin + lease under the cross-process store lock: GC in another
        # process decides retirement under the same lock, so it can never
        # delete the version between us reading the manifest and the
        # lease landing on disk
        with store_lock(self.store.root):
            with self._lock:
                if self._session_closed:
                    raise RuntimeError("AtlasSession is closed")
                # pick up versions published by other processes
                self.store.reload_manifest()
                info = self.store.servable_version_info(layer, epoch)
                e = int(info["epoch"])
                self._pins[(layer, e)] = self._pins.get((layer, e), 0) + 1
            try:
                lease = PinLease(info["dir"], ttl=self._lease_ttl)
            except BaseException:
                self._release(layer, e)
                raise
        try:
            servable = ServableLayer.open(
                info["files"], block_rows=info["block_rows"], stats=stats
            )
            use_fast = fast_path
            if use_fast == "auto":
                use_fast = (
                    cache is None
                    and cache_bytes is not None
                    and servable.data_nbytes <= int(cache_bytes)
                )
            use_fast = bool(use_fast)
            if use_fast:
                cache = None
            elif cache is None and cache_bytes:
                cache = ShardedPageCache(
                    servable.num_blocks, cache_bytes, num_shards=num_shards,
                    tracer=self.tracer, metrics=metrics,
                )
            elif cache is not None and metrics is not None:
                cache.bind_metrics(metrics)
            r = SessionReader(
                self, layer, e, servable, cache=cache, stats=stats,
                tracer=self.tracer,
                # non-identity stores serve by external id: translate
                # through the permutation sidecars (both None otherwise)
                id_map=self.store.new_of_old(),
                id_unmap=self.store.old_of_new(),
                lease=lease,
                fast_path=use_fast,
            )
        except BaseException:
            lease.release()
            self._release(layer, e)
            raise
        with self._lock:
            if not self._session_closed:
                self._readers.append(weakref.ref(r))
                return r
        # close() ran while this reader was being opened: it must not
        # escape the session's cleanup — unpin, re-collect (close()'s GC
        # skipped the then-pinned version), and refuse
        r.close()
        self.gc(layer)
        raise RuntimeError("AtlasSession is closed")

    def _release(self, layer: int, epoch: int) -> None:
        with self._lock:
            key = (layer, epoch)
            n = self._pins.get(key, 0) - 1
            if n > 0:
                self._pins[key] = n
            else:
                self._pins.pop(key, None)
            self._readers = [
                ref for ref in self._readers
                if ref() is not None and not ref()._closed
            ]

    def pinned_versions(self, layer: int) -> dict[int, int]:
        """Epoch -> open-reader count for one layer (diagnostics/tests)."""
        self._drain_finalized()
        with self._lock:
            return {
                e: n for (l, e), n in self._pins.items() if l == int(layer)
            }


__all__ = [
    "AtlasSession",
    "LayerHandle",
    "PublishedVersion",
    "RunManifest",
    "RunResult",
    "SessionReader",
    "StaleManifestError",
    "RUN_MANIFEST_SCHEMA_VERSION",
]
