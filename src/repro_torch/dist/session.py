"""``DistSession``: shard-parallel inference with one store, one manifest.

The coordinator splits internal vertex ids into ``shards`` contiguous
ranges (``ShardPlan``), runs each layer as N shard workers
(``repro_torch.dist.worker.run_shard_layer``) — threads in ``workers='thread'``
mode, per-layer ``repro_torch.launch.infer_dist --worker`` subprocesses in
``workers='process'`` mode — and advances ONE ``DistRunManifest`` only
after every shard reported its layer complete and durable (each worker
barriers its own write-back scheduler before reporting).  The only
intra-layer synchronisation is the exchange barrier; the coordinator
joins at layer boundaries.

Layer l > 0 needs no cross-shard file reads: shard ``s`` streams source
range ``[lo, hi)``, which is exactly the row range shard ``s`` itself
wrote at layer l-1 — so each shard's input is its own previous spill set,
recorded per shard in the manifest.  Layer 0 reads the store's feature
spills restricted to the shard range.

Publishing merges shard-local spills into ONE versioned servable store:
each shard compacts its own range into the staged version directory
(disjoint, ``s<NN>_``-prefixed files) and the epoch commits —
rename + manifest-pointer swap — only after the all-shard staging
barrier, through ``GraphStore.begin_servable_version`` /
``commit_servable_version``.  An unmodified ``session.reader`` then
serves the merged result by external id.

Failure model: a dead worker aborts the exchange (file marker / broken
barrier), the survivors raise ``ExchangeAborted``, the coordinator
raises ``DistWorkerError`` and the manifest stays un-advanced for that
layer — ``infer(resume=True)`` replays from the first incomplete layer
bit-identically (on exact-arithmetic graphs).

The manifest's JSON schema is the JAX package's, so either package reads
the other's ``dist_run_manifest.json``.  Process workers receive the
spec stack as plain numpy (``specs.pkl`` holds dicts, never tensors) and
rebuild it on their own device; ``exchange='mesh'`` routes over
``mesh_devices`` (one torch device per shard).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.core.atlas import AtlasConfig
from repro_torch.dist.exchange import ExchangeAborted, LocalExchange, make_exchange
from repro_torch.dist.partition import ShardPlan
from repro_torch.dist.worker import run_shard_layer
from repro_torch.graphs.csr import degrees_from_csr
from repro_torch.models.gnn import GNNLayerSpec
from repro_torch.obs.trace import merge_trace_files
from repro_torch.serve_gnn.servable import compact_spills
from repro_torch.session import (
    AtlasSession,
    LayerHandle,
    PublishedVersion,
    StaleManifestError,
)
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.layout import GraphStore
from repro_torch.storage.spill import DEFAULT_BLOCK_ROWS, SpillFile, SpillSet

DIST_MANIFEST_SCHEMA_VERSION = 1


class DistWorkerError(RuntimeError):
    """A shard worker died mid-layer; the manifest was not advanced."""

    def __init__(self, message: str, shard: int = -1, layer: int = -1):
        super().__init__(message)
        self.shard = shard
        self.layer = layer


# --------------------------------------------------------------------------
# Sharded run manifest
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DistRunManifest:
    """Schema-versioned record of one sharded run's progress.

    Same transaction rule as ``RunManifest`` — ``completed_layers``
    advances only after ALL shards' spills for the layer are durable —
    plus the shard split: ``spills[layer][shard]`` records each shard's
    own files, because they are also that shard's *input* at the next
    layer."""

    num_vertices: int
    num_layers: int
    num_shards: int
    layer_dims: list[int] = dataclasses.field(default_factory=list)
    completed_layers: int = 0
    # layer (1-based output layer) -> shard -> spill paths
    spills: dict[int, dict[int, list[str]]] = dataclasses.field(
        default_factory=dict
    )
    store_ordering: str = "original"
    store_digest: str = ""
    schema_version: int = DIST_MANIFEST_SCHEMA_VERSION

    def save(self, path: str, scheduler=None) -> None:
        payload = {
            "schema_version": self.schema_version,
            "num_vertices": self.num_vertices,
            "num_layers": self.num_layers,
            "num_shards": self.num_shards,
            "layer_dims": list(self.layer_dims),
            "completed_layers": self.completed_layers,
            "spills": {
                str(l): {str(s): v for s, v in by_shard.items()}
                for l, by_shard in self.spills.items()
            },
            "store_ordering": self.store_ordering,
            "store_digest": self.store_digest,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)
        if scheduler is not None:
            scheduler.note_dirty(path)

    @staticmethod
    def load(path: str) -> "DistRunManifest":
        try:
            with open(path) as f:
                data = json.load(f)
        except ValueError as e:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (not valid JSON: {e})"
            ) from e
        ver = data.get("schema_version") if isinstance(data, dict) else None
        if ver != DIST_MANIFEST_SCHEMA_VERSION:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (schema_version="
                f"{ver!r}, this build writes {DIST_MANIFEST_SCHEMA_VERSION})"
            )
        try:
            return DistRunManifest(
                num_vertices=int(data["num_vertices"]),
                num_layers=int(data["num_layers"]),
                num_shards=int(data["num_shards"]),
                layer_dims=[int(d) for d in data["layer_dims"]],
                completed_layers=int(data["completed_layers"]),
                spills={
                    int(l): {int(s): list(v) for s, v in by_shard.items()}
                    for l, by_shard in data.get("spills", {}).items()
                },
                store_ordering=str(data["store_ordering"]),
                store_digest=str(data["store_digest"]),
                schema_version=int(ver),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (malformed field: {e!r})"
            ) from e

    def validate_resume(
        self,
        path: str,
        num_vertices: int,
        num_shards: int,
        layer_dims: list[int],
        store_ordering: str | None = None,
        store_digest: str | None = None,
    ) -> None:
        if self.num_vertices != num_vertices:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (records "
                f"{self.num_vertices} vertices, store has {num_vertices})"
            )
        if self.num_shards != num_shards:
            # spill[layer][shard] sets are shard-range-owned: resuming
            # under a different split would hand workers partial inputs
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (run used "
                f"{self.num_shards} shards, session has {num_shards}; "
                f"resume with the same shard count or start fresh)"
            )
        if store_digest is not None and self.store_digest != store_digest:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (permutation digest "
                f"mismatch: run recorded ordering {self.store_ordering!r} "
                f"digest {self.store_digest}, store now has "
                f"{store_ordering!r} digest {store_digest})"
            )
        if self.layer_dims != list(layer_dims):
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (records layer dims "
                f"{self.layer_dims}, this run's specs have {list(layer_dims)})"
            )
        if self.completed_layers > self.num_layers:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest "
                f"({self.completed_layers} completed layers, run has only "
                f"{self.num_layers})"
            )
        if not self.completed_layers:
            return
        by_shard = self.spills.get(self.completed_layers)
        if not by_shard or sorted(by_shard) != list(range(num_shards)):
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest (incomplete shard "
                f"spill record for completed layer {self.completed_layers})"
            )
        missing = [
            p
            for paths in by_shard.values()
            for p in paths
            if not os.path.exists(p)
        ]
        if missing:
            raise StaleManifestError(
                f"{path}: stale/foreign dist manifest — "
                f"{len(missing)} spill files for layer "
                f"{self.completed_layers} are missing: {missing[:4]}"
            )


@dataclasses.dataclass
class DistRunResult:
    """What ``DistSession.infer`` returns: the sharded manifest, per-layer
    per-shard worker reports, and merged-across-shards layer handles
    (final layer always; earlier ones when ``delete_intermediate`` is
    off)."""

    manifest: DistRunManifest
    shard_reports: dict[int, list[dict]]  # 1-based layer -> [info per shard]
    layers: dict[int, LayerHandle]
    # per-shard spill sets backing each handle, keyed like `layers`;
    # publish() compacts these ranges in parallel into one staged version
    shard_spills: dict[int, list[SpillSet]]
    trace_path: str | None = None

    @property
    def final(self) -> LayerHandle:
        return self.layers[max(self.layers)]


# --------------------------------------------------------------------------
# The sharded session
# --------------------------------------------------------------------------


class DistSession:
    """Shard-parallel ``AtlasSession``: same store, same lifecycle
    (infer → publish → reader), N shard workers per layer.

    ``workers='thread'`` runs shards as threads in this process (required
    for ``exchange='mesh'``); ``workers='process'`` spawns one
    ``repro_torch.launch.infer_dist --worker`` subprocess per shard per
    layer — the single-host multi-process harness, each worker on the
    device ``config.backend`` names — and requires ``exchange='local'``.
    ``mesh_devices`` gives ``exchange='mesh'`` one torch device per shard
    (default ``cuda:0 .. cuda:S-1``; a list may repeat a device).  ``publish``/``reader``/pinning/GC delegate to
    an inner ``AtlasSession``, so serving semantics (MVCC versions, pins,
    ``retain``/``retain_ttl``) are identical to single-machine."""

    def __init__(
        self,
        store: GraphStore | str,
        shards: int = 2,
        config: AtlasConfig | None = None,
        workdir: str | None = None,
        exchange: str = "local",
        workers: str = "thread",
        trace=None,
        clock=None,
        exchange_timeout_s: float = 120.0,
        mesh_devices=None,
    ):
        self.store = GraphStore.open(store) if isinstance(store, str) else store
        self.config = config or AtlasConfig()
        self.shards = int(shards)
        if exchange not in ("local", "mesh"):
            raise ValueError(f"unknown exchange {exchange!r} (want 'local'|'mesh')")
        if workers not in ("thread", "process"):
            raise ValueError(f"unknown workers {workers!r} (want 'thread'|'process')")
        if workers == "process" and exchange != "local":
            raise ValueError(
                "workers='process' requires exchange='local' (the mesh "
                "exchange rendezvouses on an in-process barrier)"
            )
        self.exchange_kind = exchange
        self.workers_kind = workers
        self.exchange_timeout_s = exchange_timeout_s
        self.mesh_devices = None if mesh_devices is None else list(mesh_devices)
        self.workdir = workdir or os.path.join(self.store.root, "dist_run")
        self.plan = ShardPlan(
            self.store.num_vertices,
            self.shards,
            store_digest=self.store.ordering_digest,
        )
        self._session = AtlasSession(
            self.store,
            config=self.config,
            workdir=self.workdir,
            trace=trace,
            clock=clock,
        )
        self.tracer = self._session.tracer
        self._last_result: DistRunResult | None = None

    # ------------------------------------------------------------ context
    def __enter__(self) -> "DistSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._session.close()

    @property
    def run_manifest_path(self) -> str:
        return os.path.join(self.workdir, "dist_run_manifest.json")

    @property
    def exchange_root(self) -> str:
        return os.path.join(self.workdir, "exchange")

    # -------------------------------------------------------------- infer
    def infer(
        self,
        specs: list[GNNLayerSpec],
        resume: bool = False,
        fault=None,
    ) -> DistRunResult:
        """Run sharded layer-wise inference.  ``resume=True`` replays from
        the first incomplete layer of a valid ``DistRunManifest`` (same
        shard count, same store identity).  ``fault`` is a test hook —
        ``fault(shard, layer, phase)`` called from thread workers at
        stream/post checkpoints; raise from it to simulate a worker
        death."""
        store = self.store
        self._session.engine.device()  # no GPU for backend='cuda': raise before any work
        os.makedirs(self.workdir, exist_ok=True)
        manifest_path = self.run_manifest_path
        dims = [int(spec.out_dim) for spec in specs]
        manifest = DistRunManifest(
            num_vertices=store.num_vertices,
            num_layers=len(specs),
            num_shards=self.shards,
            layer_dims=dims,
            store_ordering=store.ordering_name,
            store_digest=store.ordering_digest,
        )
        if resume and os.path.exists(manifest_path):
            manifest = DistRunManifest.load(manifest_path)
            manifest.validate_resume(
                manifest_path,
                store.num_vertices,
                self.shards,
                dims,
                store_ordering=store.ordering_name,
                store_digest=store.ordering_digest,
            )
        # stale exchange state (buckets, markers, a previous run's abort
        # flag) must never leak into this run's barriers
        if os.path.exists(self.exchange_root):
            shutil.rmtree(self.exchange_root)

        csr = store.topology()
        in_deg, _ = degrees_from_csr(csr)
        done = manifest.completed_layers
        shard_sets: list[SpillSet] = []
        layers: dict[int, LayerHandle] = {}
        shard_spills: dict[int, list[SpillSet]] = {}
        reports: dict[int, list[dict]] = {}
        if done:
            shard_sets = [
                _open_spill_set(manifest.spills[done][s])
                for s in range(self.shards)
            ]
            layers[done] = _merged_handle(done, shard_sets, specs[done - 1].out_dim)
            shard_spills[done] = shard_sets

        spec_path = None
        if self.workers_kind == "process" and done < len(specs):
            # workers unpickle the full spec stack once per layer as plain
            # numpy (a spec on the card would pickle its CUDA storage) and
            # rebuild it on their own device
            spec_path = os.path.join(self.workdir, "specs.pkl")
            with open(spec_path, "wb") as f:
                pickle.dump([_spec_as_numpy(s) for s in specs], f)
            manifest.save(manifest_path)  # workers read spill paths from it

        for l in range(done, len(specs)):
            out_base = os.path.join(self.workdir, f"layer_{l + 1}")
            if os.path.exists(out_base):
                shutil.rmtree(out_base)  # partial output of a crashed attempt
            out_dirs = [
                os.path.join(out_base, f"s{s:02d}") for s in range(self.shards)
            ]
            for d in out_dirs:
                os.makedirs(d)
            # one SpillSet per shard even at layer 0 (fresh SpillFile
            # descriptors — workers stream concurrently)
            inputs = (
                [store.layer0_spills() for _ in range(self.shards)]
                if l == 0
                else shard_sets
            )
            if self.workers_kind == "thread":
                new_sets, infos = self._run_layer_threads(
                    csr, in_deg, inputs, specs[l], out_dirs, l, fault
                )
            else:
                new_sets, infos = self._run_layer_procs(
                    spec_path, l, out_dirs, out_base
                )
            # all shards durable (each worker barriered its scheduler
            # before reporting) -> NOW the manifest may advance
            manifest.completed_layers = l + 1
            manifest.spills[l + 1] = {
                s: [f.path for f in new_sets[s].files]
                for s in range(self.shards)
            }
            manifest.save(manifest_path)
            reports[l + 1] = infos
            if self.config.delete_intermediate and l > 0:
                for ss in shard_sets:
                    ss.delete_all()
                manifest.spills.pop(l, None)
                layers.pop(l, None)
                shard_spills.pop(l, None)
            shard_sets = new_sets
            layers[l + 1] = _merged_handle(l + 1, shard_sets, specs[l].out_dim)
            shard_spills[l + 1] = shard_sets

        result = DistRunResult(
            manifest=manifest,
            shard_reports=reports,
            layers=layers,
            shard_spills=shard_spills,
        )
        if self.workers_kind == "process":
            worker_traces = sorted(
                glob.glob(os.path.join(self.workdir, "trace_s*_l*.json"))
            )
            if worker_traces:
                result.trace_path = merge_trace_files(
                    worker_traces, os.path.join(self.workdir, "trace.json")
                )
        elif self.tracer.enabled:
            result.trace_path = self.tracer.export(
                os.path.join(self.workdir, "trace.json")
            )
        self._last_result = result
        self._session._last_result = None  # dist results supersede
        return result

    # ------------------------------------------------- thread-mode workers
    def _run_layer_threads(self, csr, in_deg, inputs, spec, out_dirs, l, fault):
        exch = make_exchange(
            self.exchange_kind,
            self.exchange_root,
            self.shards,
            timeout_s=self.exchange_timeout_s,
            devices=self.mesh_devices,
        )
        results: list = [None] * self.shards
        errors: list = [None] * self.shards

        def work(s: int) -> None:
            try:
                hook = (
                    None
                    if fault is None
                    else (lambda phase: fault(s, l, phase))
                )
                results[s] = run_shard_layer(
                    csr, in_deg, inputs[s], spec, out_dirs[s], l, s,
                    self.plan, exch, config=self.config, tracer=self.tracer,
                    fault=hook,
                )
            except BaseException as e:  # noqa: BLE001 — reported below
                errors[s] = e
                exch.abort(f"shard {s} layer {l}: {type(e).__name__}: {e}")

        threads = [
            threading.Thread(target=work, args=(s,), name=f"dist-shard-{s}")
            for s in range(self.shards)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fatal = [
            (s, e)
            for s, e in enumerate(errors)
            if e is not None and not isinstance(e, ExchangeAborted)
        ]
        if fatal:
            s, e = fatal[0]
            raise DistWorkerError(
                f"shard worker {s} died in layer {l}: "
                f"{type(e).__name__}: {e}",
                shard=s,
                layer=l,
            ) from e
        if any(e is not None for e in errors):
            s = next(i for i, e in enumerate(errors) if e is not None)
            raise DistWorkerError(
                f"shard worker {s} aborted in layer {l} (exchange torn "
                f"down by a peer)",
                shard=s,
                layer=l,
            ) from errors[s]
        new_sets = [r[0] for r in results]
        infos = [r[1] for r in results]
        return new_sets, infos

    # ------------------------------------------------ process-mode workers
    def _run_layer_procs(self, spec_path, l, out_dirs, out_base):
        cfg_json = json.dumps(dataclasses.asdict(self.config))
        exch = LocalExchange(
            self.exchange_root, self.shards, timeout_s=self.exchange_timeout_s
        )
        env = dict(os.environ)
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        procs = []
        result_paths = []
        for s in range(self.shards):
            result_path = os.path.join(out_base, f"result_s{s:02d}.json")
            result_paths.append(result_path)
            cmd = [
                sys.executable, "-m", "repro_torch.launch.infer_dist",
                "--worker",
                "--store", self.store.root,
                "--manifest", self.run_manifest_path,
                "--specs", spec_path,
                "--config-json", cfg_json,
                "--layer", str(l),
                "--shard", str(s),
                "--shards", str(self.shards),
                "--out-dir", out_dirs[s],
                "--exchange-root", self.exchange_root,
                "--result", result_path,
                "--spawned-at", repr(time.time()),
            ]
            if self.config.trace:
                cmd += [
                    "--trace",
                    os.path.join(self.workdir, f"trace_s{s:02d}_l{l}.json"),
                ]
            procs.append(subprocess.Popen(cmd, env=env))
        failed = None
        while True:
            alive = [p for p in procs if p.poll() is None]
            dead_bad = [
                (s, p.returncode)
                for s, p in enumerate(procs)
                if p.poll() is not None and p.returncode != 0
            ]
            if dead_bad and failed is None:
                failed = dead_bad[0]
                # wake the survivors out of their collect() polls so the
                # layer fails fast instead of timing out
                exch.abort(
                    f"shard {failed[0]} layer {l} exited "
                    f"rc={failed[1]}"
                )
            if not alive:
                break
            time.sleep(0.02)
        if failed is not None:
            raise DistWorkerError(
                f"shard worker {failed[0]} died in layer {l} "
                f"(exit code {failed[1]})",
                shard=failed[0],
                layer=l,
            )
        new_sets, infos = [], []
        for s, rp in enumerate(result_paths):
            with open(rp) as f:
                info = json.load(f)
            infos.append(info)
            new_sets.append(_open_spill_set(info["spill_paths"]))
        return new_sets, infos

    # ------------------------------------------------------------ publish
    def publish(
        self,
        layer: LayerHandle | int | None = None,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        rows_per_file: int | None = None,
        stats: IOStats | None = None,
        retain: int = 0,
        retain_ttl: float | None = None,
    ) -> PublishedVersion:
        """Publish one layer's sharded spills as ONE servable version.

        Each shard's spill set compacts in parallel into the staged
        version directory (``s<NN>_``-prefixed files over its disjoint id
        range); the epoch commits — staged dir renamed into place, store
        manifest pointer swapped — strictly after the all-shard staging
        barrier and the group-commit fsync barrier.  Retention semantics
        (``retain``, ``retain_ttl``, pins) are the inner session's."""
        if layer is None:
            if self._last_result is None:
                raise ValueError("no dist run in this session; pass a layer")
            handle = self._last_result.final
        elif isinstance(layer, LayerHandle):
            handle = layer
        else:
            if (
                self._last_result is None
                or int(layer) not in self._last_result.layers
            ):
                have = (
                    sorted(self._last_result.layers)
                    if self._last_result
                    else []
                )
                raise KeyError(
                    f"layer {layer} has no spills in this session's last "
                    f"dist run (have: {have})"
                )
            handle = self._last_result.layers[int(layer)]
        groups = self._shard_groups(handle)
        session = self._session
        store = self.store
        with session._publish_lock:
            scheduler = session._run_scheduler()
            epoch, tmp_dir = store.begin_servable_version(handle.layer)
            per_shard_files: list = [None] * len(groups)
            errors: list = [None] * len(groups)
            kwargs = {"block_rows": block_rows, "stats": stats}
            if rows_per_file is not None:
                kwargs["rows_per_file"] = rows_per_file

            def compact(i: int, prefix: str, ss: SpillSet) -> None:
                try:
                    per_shard_files[i] = compact_spills(
                        ss, tmp_dir, scheduler=scheduler, prefix=prefix,
                        **kwargs,
                    )
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors[i] = e

            threads = [
                threading.Thread(
                    target=compact, args=(i, prefix, ss),
                    name=f"dist-publish-{i}",
                )
                for i, (prefix, ss) in enumerate(groups)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()  # the all-shard staging barrier
            first_err = next((e for e in errors if e is not None), None)
            try:
                if first_err is not None:
                    raise first_err
                files = sorted(p for fs in per_shard_files for p in fs)
                info = store.commit_servable_version(
                    handle.layer, epoch, tmp_dir, files,
                    block_rows=block_rows, scheduler=scheduler,
                    published_at=session._clock(),
                )
            except BaseException:
                shutil.rmtree(tmp_dir, ignore_errors=True)
                if scheduler is not None:
                    scheduler.close(commit=False, raise_error=False)
                    session._io_sched = None
                raise
            session._published_layers.add(handle.layer)
            removed = session._gc_locked(
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

    def _shard_groups(self, handle: LayerHandle) -> list[tuple[str, SpillSet]]:
        """Per-shard compaction inputs: the run's own per-shard sets when
        available, else regroup the handle's files by owning shard (every
        shard-worker file lies wholly inside one range).  A file spanning
        shard boundaries (foreign spills) falls back to one unprefixed
        group — still correct, just unparallelised."""
        if (
            self._last_result is not None
            and handle.layer in self._last_result.shard_spills
        ):
            sets = self._last_result.shard_spills[handle.layer]
            return [
                (f"s{s:02d}_", ss) for s, ss in enumerate(sets) if ss.files
            ]
        groups: dict[int, SpillSet] = {}
        for f in handle.spills.files:
            lo_shard = int(self.plan.shard_of([f.min_id])[0])
            hi_shard = int(self.plan.shard_of([max(f.min_id, f.max_id)])[0])
            if lo_shard != hi_shard:
                return [("", handle.spills)]
            groups.setdefault(lo_shard, SpillSet()).add(f)
        return [(f"s{s:02d}_", groups[s]) for s in sorted(groups)]

    # ------------------------------------------------------------- reader
    def reader(self, layer: int, **kwargs):
        """A pinned query engine over the merged published version —
        the unmodified single-machine ``AtlasSession.reader``."""
        return self._session.reader(layer, **kwargs)

    def gc(self, layer: int, retain: int = 0, retain_ttl: float | None = None):
        return self._session.gc(layer, retain=retain, retain_ttl=retain_ttl)

    def pinned_versions(self, layer: int):
        return self._session.pinned_versions(layer)


def _spec_as_numpy(spec: GNNLayerSpec) -> dict:
    """A spec as the plain description ``specs_from_numpy`` takes, every
    parameter a host numpy array."""
    return {
        "kind": spec.kind,
        "in_dim": spec.in_dim,
        "out_dim": spec.out_dim,
        "activation": spec.activation,
        "params": {
            k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in spec.params.items()
        },
    }


def _open_spill_set(paths: list[str]) -> SpillSet:
    ss = SpillSet()
    for p in paths:
        ss.add(SpillFile.open(p))
    return ss


def _merged_handle(
    layer: int, shard_sets: list[SpillSet], dim: int
) -> LayerHandle:
    merged = SpillSet()
    for ss in shard_sets:
        for f in ss.files:
            merged.add(f)
    return LayerHandle(
        layer=layer, spills=merged, num_rows=merged.total_rows(), dim=dim
    )


__all__ = [
    "DIST_MANIFEST_SCHEMA_VERSION",
    "DistRunManifest",
    "DistRunResult",
    "DistSession",
    "DistWorkerError",
]
