"""`AtlasSession`: the run side of the ATLAS lifecycle behind one API.

    with AtlasSession(store, config=cfg) as session:
        result = session.infer(specs)            # typed RunResult

``infer`` runs layer-wise out-of-core inference (paper §3) and records
completed layers in a schema-versioned ``run_manifest.json``
(``RunManifest``, the same JSON as the JAX package writes);
``resume=True`` validates the manifest's schema, store identity, and
spill files before touching anything, failing with a clear
``StaleManifestError`` instead of a raw ``FileNotFoundError`` mid-resume.

Durability: with ``AtlasConfig.io_impl="writeback"`` (default) the
session owns one write-back I/O scheduler for the run, and the engine
barriers each layer before ``infer`` records it in the run manifest —
so every crash window resolves to "manifest un-advanced, replay".

Publishing a layer as a served version and reading it back
(``publish``/``reader``/``gc``) belong to the serving slice of the port;
until it lands they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from repro_torch.core.atlas import AtlasConfig, AtlasEngine, LayerMetrics
from repro_torch.graphs.csr import degrees_from_csr
from repro_torch.models.gnn import GNNLayerSpec
from repro_torch.obs.sampler import ResourceSampler
from repro_torch.obs.trace import as_tracer
from repro_torch.storage.io_scheduler import make_scheduler
from repro_torch.storage.layout import GraphStore
from repro_torch.storage.spill import SpillFile, SpillSet

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


# --------------------------------------------------------------------------
# The session
# --------------------------------------------------------------------------


class AtlasSession:
    """Owns one store's inference workdir.

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
    ):
        self.store = GraphStore.open(store) if isinstance(store, str) else store
        self.engine = engine if engine is not None else AtlasEngine(config)
        self.workdir = workdir or os.path.join(self.store.root, "run")
        # trace: None defers to AtlasConfig.trace; True/False overrides
        # it; a Tracer instance is used directly (one timeline can span
        # several sessions/runs)
        if trace is None:
            trace = self.engine.config.trace
        self.tracer = as_tracer(trace)
        self._io_sched = None  # the run-shared write-back scheduler

    def _run_scheduler(self):
        """The session's run-shared write-back scheduler (None when the
        engine config runs ``io_impl='sync'``): one instance serves every
        layer of an ``infer`` run, so queue depth and fsync accounting
        (``QueueStats``) are global across layers.  Created lazily,
        recreated after an error retired it; ``close`` tears it down."""
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

    def close(self) -> None:
        """Reclaim the session's I/O thread, if one is still up."""
        if self._io_sched is not None:
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
            # not poison a later run; the lazy getter recreates it
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

    # ----------------------------------------------------- serving slice
    def publish(self, *args, **kwargs):
        raise NotImplementedError(
            "AtlasSession.publish belongs to the serving slice of the port "
            "(publish/reader/serve_gnn), which has not landed yet"
        )

    def reader(self, *args, **kwargs):
        raise NotImplementedError(
            "AtlasSession.reader belongs to the serving slice of the port "
            "(publish/reader/serve_gnn), which has not landed yet"
        )

    def gc(self, *args, **kwargs):
        raise NotImplementedError(
            "AtlasSession.gc (and retain) belong to the serving slice of the "
            "port (publish/reader/serve_gnn), which has not landed yet"
        )


__all__ = [
    "AtlasSession",
    "LayerHandle",
    "RunManifest",
    "RunResult",
    "StaleManifestError",
    "RUN_MANIFEST_SCHEMA_VERSION",
]
