"""On-disk graph store (paper §3.2) and the vertex ID namespace boundary.

Topology: CSR (`indptr.npy`, `indices.npy`), memory-mapped — O(V+E) on disk,
sequential offset-based access for the reader.
Features: one initial sorted spill file per range partition (ids 0..V-1 in
order), so layer 0 and layer k>0 are read through the identical
merge-on-read path.
A JSON manifest records shapes/dtypes/partitioning and makes the store
re-openable (and resumable mid-inference).

Vertex ordering (paper §3.8): ``create(order=...)`` relabels the graph
into storage order at build time — topology rewritten, features streamed
into the reordered partitioned layout — and records the *ID namespace*
in the store:

* everything inside the store (topology, spill ids, servable files, the
  engine) speaks **internal** ids — positions in storage order;
* callers keep speaking **external** ids — the original vertex numbering.

The permutation is persisted as two mmap-loadable int64 sidecars,
``old_of_new.npy`` (internal → external; the order itself) and
``new_of_old.npy`` (external → internal; what serving translates
through), plus an ``ordering`` manifest block carrying the canonical
ordering name and a sha256-based permutation digest — the identity that
``RunManifest`` pins so a resumed run fails fast (``StaleManifestError``)
when the store was rebuilt under a different permutation.  Stores built
with ``order="original"`` (and all pre-ordering stores) have an identity
namespace: no sidecars, translation is a no-op.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
from typing import Iterable, Iterator

import numpy as np

from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.partition import RangePartition
from repro_torch.storage.iostats import IOStats
from repro_torch.storage.spill import DEFAULT_BLOCK_ROWS, SpillFile, SpillSet, write_spill


def _feature_chunks(features) -> Iterator[np.ndarray]:
    """Normalise the features argument: a dense [V, d] array is one chunk,
    anything else is treated as an iterable of [n_i, d] row chunks."""
    if isinstance(features, np.ndarray):
        yield features
    else:
        for chunk in features:
            yield np.asarray(chunk)


#: sidecar filenames for the on-disk permutation (int64 .npy, mmap-loadable)
OLD_OF_NEW_FILE = "old_of_new.npy"  # internal id -> external id (the order)
NEW_OF_OLD_FILE = "new_of_old.npy"  # external id -> internal id (its inverse)


class GraphStore:
    def __init__(self, root: str):
        self.root = root
        self.manifest_path = os.path.join(root, "manifest.json")
        self.manifest: dict = {}
        # serializes manifest mutate-and-write sections against
        # reload_manifest: a reload that swaps `self.manifest` mid-commit
        # would strand the commit's mutations on the orphaned dict and
        # regress next_epoch (epoch reuse under live readers)
        self._manifest_mutex = threading.Lock()
        self._csr: CSRGraph | None = None
        self._old_of_new: np.ndarray | None = None  # lazy sidecar mmaps
        self._new_of_old: np.ndarray | None = None
        self._identity_digest: str | None = None  # cached for legacy stores

    # ------------------------------------------------------------- create
    @staticmethod
    def create(
        root: str,
        csr: CSRGraph,
        features: np.ndarray | Iterable[np.ndarray],
        num_partitions: int = 8,
        feature_rows_per_spill: int | None = None,
        stats: IOStats | None = None,
        order: str | np.ndarray = "original",
        order_seed: int = 0,
    ) -> "GraphStore":
        """Build a store from a dense [V, d] feature array or — for layer-0
        stores larger than RAM — any iterable of [n_i, d] row chunks in
        vertex-id order.  Only one spill file's worth of rows is ever
        buffered from an iterator.

        ``order`` selects the storage-order vertex namespace: an ordering
        name (``"original"`` | ``"atlas"`` | ``"random"``, aliases
        ``og``/``at``/``rnd`` accepted; ``atlas`` is the paper's §3.8
        greedy completion-rate order) or an explicit permutation array
        with ``order[rank] = external_id``.  Any non-identity order
        relabels the topology and streams the features through
        ``iter_relabeled_feature_chunks`` into the same partitioned
        layout, persists the permutation sidecars next to the topology,
        and records the ordering name + digest in the manifest — the
        engine then runs purely in internal ids while serving translates
        external ids through the sidecar.  A non-identity ``order``
        requires randomly-addressable ``features`` (ndarray or memmap,
        e.g. ``make_features_mmap``), not a chunk iterator.
        """
        from repro_torch.core.reorder import (
            canonical_order_name,
            iter_relabeled_feature_chunks,
            make_order,
            permutation_digest,
            relabel_graph,
            relabel_map,
            validate_permutation,
        )

        v = csr.num_vertices
        if isinstance(order, str):
            order_name = canonical_order_name(order)
            perm = (
                None
                if order_name == "original"
                else make_order(order_name, csr, seed=order_seed)
            )
        else:
            perm = validate_permutation(order, v)
            order_name = "custom"
        if perm is not None and np.array_equal(perm, np.arange(v)):
            perm, order_name = None, "original"  # identity: no translation
        if perm is not None:
            if not isinstance(features, np.ndarray):
                raise TypeError(
                    f"order={order_name!r} must gather features in storage "
                    "order; pass a randomly-addressable array (ndarray or "
                    "np.memmap, e.g. make_features_mmap), not a chunk iterator"
                )
            csr = relabel_graph(csr, perm)
            features = iter_relabeled_feature_chunks(features, perm)

        os.makedirs(root, exist_ok=True)
        os.makedirs(os.path.join(root, "features_l0"), exist_ok=True)
        np.save(os.path.join(root, "indptr.npy"), csr.indptr)
        np.save(os.path.join(root, "indices.npy"), csr.indices)
        ordering_entry = {
            "name": order_name,
            "digest": permutation_digest(perm, num_vertices=v),
        }
        if perm is not None:
            # sidecars land before the manifest references them, so a
            # readable manifest always finds its translation tables
            np.save(
                os.path.join(root, OLD_OF_NEW_FILE), perm.astype(np.int64)
            )
            np.save(
                os.path.join(root, NEW_OF_OLD_FILE),
                relabel_map(perm).astype(np.int64),
            )
            ordering_entry["old_of_new"] = OLD_OF_NEW_FILE
            ordering_entry["new_of_old"] = NEW_OF_OLD_FILE
        part = RangePartition(v, num_partitions)
        chunks = _feature_chunks(features)
        carry = np.empty((0, 0))  # rows yielded but not yet written
        feat_dim: int | None = None
        feat_dtype: np.dtype | None = None
        files = []
        for p in range(num_partitions):
            lo, hi = part.range_of(p)
            step = feature_rows_per_spill or (hi - lo)
            for s0 in range(lo, hi, max(step, 1)):
                s1 = min(s0 + step, hi)
                parts = [carry] if len(carry) else []
                got = len(carry)
                while got < s1 - s0:
                    try:
                        chunk = next(chunks)
                    except StopIteration:
                        raise ValueError(
                            f"feature chunks yielded {s0 + got} rows, "
                            f"expected {v}"
                        ) from None
                    if chunk.ndim != 2:
                        raise ValueError("feature chunks must be [n, dim]")
                    if feat_dim is None:
                        feat_dim, feat_dtype = chunk.shape[1], chunk.dtype
                    elif chunk.shape[1] != feat_dim or chunk.dtype != feat_dtype:
                        raise ValueError(
                            f"feature chunk [{len(chunk)}, {chunk.shape[1]}] "
                            f"{chunk.dtype} disagrees with first chunk "
                            f"(dim {feat_dim}, {feat_dtype})"
                        )
                    parts.append(chunk)
                    got += len(chunk)
                rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
                rows, carry = rows[: s1 - s0], rows[s1 - s0 :]
                path = os.path.join(root, "features_l0", f"part{p:04d}_{s0}.spill")
                sf = write_spill(
                    path,
                    np.arange(s0, s1, dtype=np.uint64),
                    rows,
                    stats=stats,
                    presorted=True,
                )
                files.append(sf.path)
        extra = len(carry)
        for chunk in chunks:  # trailing empty chunks are fine
            extra += len(np.asarray(chunk))
            if extra:
                break
        if extra:
            raise ValueError(f"feature chunks yielded more rows than {v} vertices")
        store = GraphStore(root)
        store.manifest = {
            "num_vertices": v,
            "num_edges": csr.num_edges,
            "feat_dim": int(feat_dim),
            "feat_dtype": str(feat_dtype),
            "num_partitions": num_partitions,
            "ordering": ordering_entry,
            "layer0_files": files,
        }
        store._write_manifest()
        return store

    def _write_manifest(self, scheduler=None) -> None:
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f, indent=2)
        os.replace(tmp, self.manifest_path)
        if scheduler is not None:
            # group-commit the manifest swap: durability rides the
            # write-back scheduler's next barrier instead of an inline
            # fsync — ordering (data durable -> manifest advance) is
            # already guaranteed by the barrier *before* this write
            scheduler.note_dirty(self.manifest_path)

    # --------------------------------------------------------------- open
    @staticmethod
    def open(root: str) -> "GraphStore":
        store = GraphStore(root)
        with open(store.manifest_path) as f:
            store.manifest = json.load(f)
        return store

    def reload_manifest(self) -> None:
        """Re-read the manifest from disk, picking up versions published
        (or GC'd) by *other processes* sharing this store.  Every
        manifest mutation is written through ``_write_manifest`` before
        its caller returns, so disk is always at least as new as this
        process's memory — reloading can only move forward.  Topology
        and permutation sidecars are immutable; their caches survive.

        Serialized against in-process manifest writers by the manifest
        mutex: replacing ``self.manifest`` in the middle of a publish
        commit would strand the commit's version entry on the orphaned
        dict (and regress ``next_epoch`` into epoch reuse)."""
        with self._manifest_mutex:
            try:
                with open(self.manifest_path) as f:
                    self.manifest = json.load(f)
            except FileNotFoundError:
                pass  # store being created concurrently: keep what we have

    # ------------------------------------------------------------ access
    @property
    def num_vertices(self) -> int:
        return self.manifest["num_vertices"]

    @property
    def num_edges(self) -> int:
        return self.manifest["num_edges"]

    @property
    def feat_dim(self) -> int:
        return self.manifest["feat_dim"]

    def topology(self) -> CSRGraph:
        """Memory-mapped CSR topology (not counted as feature I/O; the
        paper counts topology reads separately and they are O(V+E) once)."""
        if self._csr is None:
            indptr = np.load(os.path.join(self.root, "indptr.npy"), mmap_mode="r")
            indices = np.load(os.path.join(self.root, "indices.npy"), mmap_mode="r")
            self._csr = CSRGraph(indptr=indptr, indices=indices)
        return self._csr

    # ------------------------------------------------- vertex ID namespace
    @property
    def ordering_name(self) -> str:
        """Canonical name of the storage ordering (``original`` for every
        pre-ordering store)."""
        return self.manifest.get("ordering", {}).get("name", "original")

    @property
    def ordering_digest(self) -> str:
        """Permutation digest of the storage ordering — the namespace
        identity ``RunManifest`` pins for resume validation.  Legacy
        manifests (no ``ordering`` block) digest the identity permutation
        once and cache it."""
        digest = self.manifest.get("ordering", {}).get("digest")
        if digest:
            return digest
        if self._identity_digest is None:
            from repro_torch.core.reorder import permutation_digest

            self._identity_digest = permutation_digest(
                None, num_vertices=self.num_vertices
            )
        return self._identity_digest

    def _ordering_sidecar(self, key: str) -> np.ndarray | None:
        name = self.manifest.get("ordering", {}).get(key)
        if name is None:
            return None
        path = os.path.join(self.root, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"store manifest records ordering sidecar {name!r} but "
                f"{path} is missing — the store is corrupt or half-copied"
            )
        return np.load(path, mmap_mode="r")

    def old_of_new(self) -> np.ndarray | None:
        """Internal → external id map (mmap), or None when the namespace
        is the identity (``order='original'`` / legacy stores)."""
        if self._old_of_new is None:
            self._old_of_new = self._ordering_sidecar("old_of_new")
        return self._old_of_new

    def new_of_old(self) -> np.ndarray | None:
        """External → internal id map (mmap), or None for the identity
        namespace — serving translates lookups through this."""
        if self._new_of_old is None:
            self._new_of_old = self._ordering_sidecar("new_of_old")
        return self._new_of_old

    def to_internal(self, external_ids: np.ndarray) -> np.ndarray:
        """Translate external (original) vertex ids to internal (storage
        order) ids; identity-free when the store is unordered."""
        ids = np.asarray(external_ids)
        m = self.new_of_old()
        return ids if m is None else np.asarray(m[ids])

    def to_external(self, internal_ids: np.ndarray) -> np.ndarray:
        """Translate internal (storage order) ids back to the caller's
        external ids."""
        ids = np.asarray(internal_ids)
        m = self.old_of_new()
        return ids if m is None else np.asarray(m[ids])

    def layer0_spills(self) -> SpillSet:
        ss = SpillSet()
        for path in self.manifest["layer0_files"]:
            ss.add(SpillFile.open(path))
        return ss

    # ----------------------------------------------------------- serving
    #
    # Servable layers are *versioned* (MVCC): every publish compacts into a
    # fresh epoch-numbered directory ``servable_l<L>/v<epoch>/`` and the
    # manifest entry for the layer is a pointer swap:
    #
    #     "servable_layers": {"2": {
    #         "current": 3, "next_epoch": 4,
    #         "versions": {"3": {"epoch": 3, "dir": ..., "files": [...],
    #                            "block_rows": ..., "num_rows": ...,
    #                            "dim": ..., "dtype": ...}},
    #         ...plus a flat mirror of the current version's fields for
    #         pre-versioning readers ("files", "block_rows", ...)
    #     }}
    #
    # Published version directories are immutable; a re-publish never touches
    # an existing version's files, so a reader opened against epoch N keeps
    # serving bit-identical rows while epoch N+1 lands.  Retiring old
    # versions is the caller's job (``repro_torch.session.AtlasSession``
    # refcounts open readers and GCs unpinned stale versions on the next
    # publish).
    def _layer_base_dir(self, layer: int) -> str:
        return os.path.join(self.root, f"servable_l{layer}")

    def _servable_entry(self, layer: int, create: bool = False) -> dict:
        """The (normalized) manifest entry for one servable layer.

        Entries written by pre-versioning builds are flat file lists; they
        are wrapped in place as epoch 1 so every consumer sees the
        versioned shape.
        """
        if create:
            layers = self.manifest.setdefault("servable_layers", {})
        else:
            layers = self.manifest.get("servable_layers", {})
        key = str(int(layer))
        entry = layers.get(key)
        if entry is None:
            if not create:
                # list() snapshots atomically: concurrent publishes may be
                # inserting entries while an error path formats this
                raise KeyError(
                    f"layer {layer} not registered as servable "
                    f"(have: {sorted(list(layers))})"
                )
            entry = {"current": None, "next_epoch": 1, "versions": {}}
            layers[key] = entry
        elif "versions" not in entry:
            # legacy flat entry: its files live directly in the layer base
            # dir (no v-subdir), so record dir=base and delete per-file on GC
            info = {
                k: entry[k]
                for k in ("files", "block_rows", "num_rows", "dim", "dtype")
            }
            info["epoch"] = 1
            info["dir"] = self._layer_base_dir(layer)
            entry.update(
                {"current": 1, "next_epoch": 2, "versions": {"1": info}}
            )
        return entry

    def begin_servable_version(self, layer: int) -> tuple[int, str]:
        """Reserve the next epoch of ``layer`` and create its staging
        directory (``v<epoch>.compact``).  Writers — one, or one per shard
        of a distributed publish — compact into the staging dir, then the
        version lands atomically via ``commit_servable_version``.  Nothing
        is recorded in the manifest until commit, so an abandoned staging
        dir is reclaimed by the orphan sweep.  begin/commit pairs must be
        serialized by the caller (``AtlasSession`` holds its publish
        lock)."""
        try:
            entry = self._servable_entry(layer)
            epoch = int(entry.get("next_epoch") or 1)
        except KeyError:
            epoch = 1
        out_dir = os.path.join(self._layer_base_dir(layer), f"v{epoch:06d}")
        tmp_dir = out_dir + ".compact"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        return epoch, tmp_dir

    def commit_servable_version(
        self,
        layer: int,
        epoch: int,
        tmp_dir: str,
        files: list[str],
        block_rows: int = DEFAULT_BLOCK_ROWS,
        scheduler=None,
        published_at: float | None = None,
    ) -> dict:
        """Land a staged version: group-commit barrier → rename the
        staging dir into ``v<epoch>`` → swap the manifest's
        current-version pointer.  ``files`` are the staged spill paths
        (inside ``tmp_dir``); their id ranges must be pairwise disjoint —
        ``ServableLayer.open`` re-validates on first read.  With a
        write-back ``scheduler`` every staged file plus the staging dir
        is fsynced by one ``barrier()`` strictly before the rename, so
        the crash ordering is data durable → rename → manifest.
        ``published_at`` (epoch seconds) is recorded for age-based
        retention (``retain_ttl``)."""
        from repro_torch.storage.io_scheduler import fsync_dir

        if not files:
            raise ValueError("cannot commit a servable version with no files")
        out_dir = os.path.join(self._layer_base_dir(layer), f"v{epoch:06d}")
        if scheduler is not None:
            # group commit: every staged file (and the staging dir)
            # durable before the version can be renamed into place
            scheduler.barrier()
        if os.path.exists(out_dir):  # leftover of a crashed, unrecorded publish
            shutil.rmtree(out_dir)
        os.replace(tmp_dir, out_dir)
        if scheduler is not None:
            # make the rename itself durable before the manifest
            # records the version
            fsync_dir(self._layer_base_dir(layer))
            fsync_dir(self.root)
        files = [os.path.join(out_dir, os.path.basename(p)) for p in files]
        opened = [SpillFile.open(p) for p in files]
        num_rows = sum(f.num_rows for f in opened)
        info = {
            "epoch": int(epoch),
            "dir": out_dir,
            "files": files,
            "block_rows": int(block_rows),
            "num_rows": int(num_rows),
            "dim": opened[0].dim,
            "dtype": str(opened[0].dtype),
        }
        if published_at is not None:
            info["published_at"] = float(published_at)
        # the entry is only created/mutated after every fallible step above
        # succeeded, so a failed commit never leaves a phantom entry; the
        # manifest mutex keeps a concurrent reload_manifest from swapping
        # self.manifest between the entry fetch and the write (which would
        # drop this version from the saved manifest and reuse its epoch)
        with self._manifest_mutex:
            entry = self._servable_entry(layer, create=True)
            # version entry first, current pointer second: a concurrent
            # reader that observes the new current always finds its
            # version recorded
            entry["versions"][str(int(epoch))] = info
            entry["current"] = int(epoch)
            entry["next_epoch"] = max(
                int(entry.get("next_epoch") or 1), int(epoch) + 1
            )
            for k in ("files", "block_rows", "num_rows", "dim", "dtype"):
                entry[k] = info[k]  # flat mirror for pre-versioning readers
            self._write_manifest(scheduler=scheduler)
        self._sweep_orphan_versions(layer, entry)
        return info

    def publish_servable_layer(
        self,
        layer: int,
        spills: SpillSet,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        rows_per_file: int | None = None,
        stats: IOStats | None = None,
        scheduler=None,
        published_at: float | None = None,
    ) -> dict:
        """Compact one layer's (possibly overlapping) spill set into a new
        epoch-numbered servable version directory and swap the manifest's
        current-version pointer to it atomically.  Returns the new
        version-info dict (``epoch``, ``dir``, ``files``, ``block_rows``,
        ``num_rows``, ``dim``, ``dtype``).  A convenience over the
        ``begin_servable_version`` / ``commit_servable_version`` pair (the
        distributed publish path drives those directly, one compaction per
        shard into the shared staging dir).

        With a write-back ``scheduler`` the staged files stream through
        its I/O thread and the whole staged version dir is
        **group-committed** — one ``barrier()`` fsyncing every file plus
        the staging dir — strictly before the rename into place and the
        manifest pointer swap, preserving the publish crash-consistency
        ordering (data durable → rename → manifest).

        Existing versions are never modified or removed here — see
        ``drop_servable_version`` / ``AtlasSession.publish`` for GC.
        """
        from repro_torch.serve_gnn.servable import DEFAULT_ROWS_PER_FILE, compact_spills

        epoch, tmp_dir = self.begin_servable_version(layer)
        try:
            tmp_files = compact_spills(
                spills,
                tmp_dir,
                rows_per_file=rows_per_file or DEFAULT_ROWS_PER_FILE,
                block_rows=block_rows,
                stats=stats,
                scheduler=scheduler,
            )
            return self.commit_servable_version(
                layer,
                epoch,
                tmp_dir,
                tmp_files,
                block_rows=block_rows,
                scheduler=scheduler,
                published_at=published_at,
            )
        except BaseException:
            # a failed publish never lands a half-written version (and
            # never touches the currently published one)
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise

    _VERSION_DIR = re.compile(r"^v\d{6}(\.compact)?$")

    def _sweep_orphan_versions(self, layer: int, entry: dict) -> None:
        """Remove version-shaped directories the manifest doesn't record.

        A crash between un-recording a version and deleting its files
        (``drop_servable_version``'s ordering — manifest first, so a
        recorded version never has missing files) leaves an orphan
        ``v<epoch>/`` dir; epochs are never reused, so only this sweep can
        reclaim it.  Orphans are by construction unpinned: a version must
        be recorded to be opened, and pins are in-process state that died
        with the crashed process."""
        base = self._layer_base_dir(layer)
        recorded = {
            os.path.abspath(v["dir"]) for v in entry["versions"].values()
        }
        try:
            names = os.listdir(base)
        except FileNotFoundError:
            return
        for name in names:
            path = os.path.join(base, name)
            if (
                self._VERSION_DIR.match(name)
                and os.path.isdir(path)
                and os.path.abspath(path) not in recorded
            ):
                shutil.rmtree(path, ignore_errors=True)

    def register_servable_layer(
        self,
        layer: int,
        spills: SpillSet,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        rows_per_file: int | None = None,
        stats: IOStats | None = None,
    ) -> list[str]:
        """Deprecated: use ``AtlasSession.publish`` (or
        ``publish_servable_layer`` directly).  Publishes a new version and —
        matching the old replace-in-place contract — immediately drops every
        older version, with no regard for open readers.
        """
        warnings.warn(
            "GraphStore.register_servable_layer is deprecated; use "
            "repro_torch.session.AtlasSession.publish (versioned, reader-safe) or "
            "GraphStore.publish_servable_layer",
            DeprecationWarning,
            stacklevel=2,
        )
        info = self.publish_servable_layer(
            layer,
            spills,
            block_rows=block_rows,
            rows_per_file=rows_per_file,
            stats=stats,
        )
        for epoch in self.servable_versions(layer):
            if epoch != info["epoch"]:
                self.drop_servable_version(layer, epoch)
        return info["files"]

    def servable_layers(self) -> list[int]:
        return sorted(int(k) for k in self.manifest.get("servable_layers", {}))

    def servable_versions(self, layer: int) -> list[int]:
        """Epoch numbers currently on disk for one servable layer."""
        # list() snapshots the keys atomically w.r.t. a concurrent publish
        return sorted(
            int(k) for k in list(self._servable_entry(layer)["versions"])
        )

    def current_servable_epoch(self, layer: int) -> int:
        entry = self._servable_entry(layer)
        if entry.get("current") is None:
            raise KeyError(f"layer {layer} has no published servable version")
        return int(entry["current"])

    def servable_version_info(self, layer: int, epoch: int | None = None) -> dict:
        """Version-info dict for ``epoch`` (default: the current version)."""
        entry = self._servable_entry(layer)
        if epoch is None and entry.get("current") is None:
            raise KeyError(f"layer {layer} has no published servable version")
        e = int(entry["current"]) if epoch is None else int(epoch)
        info = entry["versions"].get(str(e))
        if info is None:
            raise KeyError(
                f"layer {layer} has no servable version {e} "
                f"(have: {self.servable_versions(layer)})"
            )
        return info

    def drop_servable_version(
        self, layer: int, epoch: int, delete_files: bool = True
    ) -> dict:
        """Remove one non-current servable version: manifest entry first
        (so a crash mid-delete never leaves a recorded version with missing
        files), then its files.  Refuses to drop the current version.

        ``delete_files=False`` retires only the manifest entry and leaves
        file removal to the caller via ``delete_servable_files`` — used by
        ``AtlasSession.gc`` to keep slow disk deletion out of its pin
        lock."""
        epoch = int(epoch)
        with self._manifest_mutex:
            entry = self._servable_entry(layer)
            if entry.get("current") == epoch:
                raise ValueError(
                    f"layer {layer}: refusing to drop the current servable "
                    f"version {epoch}; publish a newer one first"
                )
            info = entry["versions"].pop(str(epoch), None)
            if info is None:
                raise KeyError(f"layer {layer} has no servable version {epoch}")
            self._write_manifest()
        if delete_files:
            self.delete_servable_files(layer, info)
        return info

    def delete_servable_files(self, layer: int, info: dict) -> None:
        """Delete a retired (already un-recorded) version's files."""
        vdir = info.get("dir")
        base = self._layer_base_dir(layer)
        if vdir and os.path.abspath(vdir) != os.path.abspath(base):
            shutil.rmtree(vdir, ignore_errors=True)
        else:
            # legacy flat layout: files sit in the base dir next to the
            # version subdirs — remove them individually
            for p in info["files"]:
                for path in (p, p + ".idx"):
                    try:
                        os.remove(path)
                    except FileNotFoundError:
                        pass

    def layer_dir(self, layer: int) -> str:
        d = os.path.join(self.root, f"embeddings_l{layer}")
        os.makedirs(d, exist_ok=True)
        return d

    def topology_nbytes(self) -> int:
        csr = self.topology()
        return csr.indptr.nbytes + csr.indices.nbytes
