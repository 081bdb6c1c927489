"""Servable embedding layers: compaction + the block-addressed read view.

``AtlasEngine.run`` leaves one layer's embeddings as a *spill set*: sorted
immutable files whose id ranges overlap (each partition flushes its buffer
many times).  That layout is perfect for the write path but poor for point
lookups — a vertex could live in any of the overlapping files.

``compact_spills`` performs a one-time streaming merge into *servable*
files with pairwise-disjoint id ranges (each holding a contiguous run of
the globally sorted ids), every file carrying its sidecar block index.
After compaction a vertex lookup is: binary search for the file, binary
search the file's block bounds, read exactly one block.

``ServableLayer`` is the opened read view: spill descriptors (file
handles are opened per read, so open-fd count stays bounded) + loaded
(rebuilt if needed) block indexes + the global block-key numbering the
page cache and query engine share.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from repro_torch.storage.iostats import IOStats
from repro_torch.storage.spill import (
    DEFAULT_BLOCK_ROWS,
    BlockIndex,
    SpillFile,
    SpillSet,
    write_spill,
)

DEFAULT_ROWS_PER_FILE = 1 << 18  # 256k rows per servable file


def compact_spills(
    spills: SpillSet,
    out_dir: str,
    rows_per_file: int = DEFAULT_ROWS_PER_FILE,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    stats: IOStats | None = None,
    scheduler=None,
    prefix: str = "",
) -> list[str]:
    """Merge an overlapping spill set into disjoint sorted servable files.

    ``prefix`` namespaces the output filenames (``<prefix>servable_<i>``)
    so several compactions over disjoint id ranges — one per shard of a
    distributed run — can stage into the same version directory.

    Memory stays bounded: only the id columns (8 bytes/row) are held to
    compute the global cut points; row data streams through one target
    file at a time via the existing merge-on-read range reads.

    With a ``repro_torch.storage.io_scheduler.WritebackIOScheduler``, each
    target file is handed off to the I/O thread (the merged arrays are
    freshly allocated, so the hand-off is by reference) and durability
    is deferred to the caller's group-commit barrier — the publish path
    barriers once before renaming the staged version dir into place.
    Without one, every file is written + fsynced inline (sync oracle).
    """
    if not spills.files:
        raise ValueError("cannot compact an empty spill set")
    os.makedirs(out_dir, exist_ok=True)
    # id columns (8 bytes/row) are read once and kept: they give both the
    # global cut points and each raw file's row bounds per output file, so
    # row data is the only thing read per target (read_rows, no re-reads)
    id_cols = [f.read_ids(stats) for f in spills.files]
    all_ids = np.sort(np.concatenate(id_cols))
    if len(np.unique(all_ids)) != len(all_ids):
        raise ValueError("duplicate vertex rows across spill files")
    n = len(all_ids)
    rows_per_file = max(1, int(rows_per_file))
    paths: list[str] = []
    for i, start in enumerate(range(0, n, rows_per_file)):
        lo = int(all_ids[start])
        end = min(start + rows_per_file, n)
        hi = int(all_ids[end - 1]) + 1
        parts = []
        for f, fids in zip(spills.files, id_cols):
            a = int(np.searchsorted(fids, lo, side="left"))
            b = int(np.searchsorted(fids, hi, side="left"))
            if b > a:
                parts.append((fids[a:b], f.read_rows(a, b, stats)))
        ids = np.concatenate([p[0] for p in parts])
        rows = np.concatenate([p[1] for p in parts])
        order = np.argsort(ids, kind="stable")
        ids, rows = ids[order], rows[order]
        assert len(ids) == end - start
        path = os.path.join(out_dir, f"{prefix}servable_{i:05d}.spill")
        if scheduler is not None:
            scheduler.submit_spill(
                path, ids, rows, stats=stats, presorted=True,
                block_rows=block_rows,
            )
        else:
            write_spill(
                path, ids, rows, stats=stats, presorted=True,
                block_rows=block_rows,
            )
        paths.append(path)
    return paths


@dataclasses.dataclass
class ServableLayer:
    """Opened read view over disjoint servable files.

    Global block key of block b in file f is ``block_base[f] + b`` — a
    dense integer space shared with the page cache's intrusive lists.
    """

    files: list[SpillFile]
    indexes: list[BlockIndex]
    file_min: np.ndarray  # u64 [n_files], sorted
    file_max: np.ndarray  # u64 [n_files]
    block_base: np.ndarray  # i64 [n_files], prefix sum of per-file blocks
    num_rows: int
    dim: int
    dtype: np.dtype
    file_block_rows: np.ndarray = None  # i64 [n_files], per-file block size
    epoch: int | None = None  # published version this view was opened at
    _id_cols: list = dataclasses.field(default=None, repr=False)
    _row_views: list = dataclasses.field(default=None, repr=False)
    _id_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )

    @property
    def num_blocks(self) -> int:
        return int(self.block_base[-1]) + self.indexes[-1].num_blocks

    @staticmethod
    def open(
        paths: list[str],
        block_rows: int = DEFAULT_BLOCK_ROWS,
        stats: IOStats | None = None,
    ) -> "ServableLayer":
        """Open servable files, loading each sidecar index (transparently
        rebuilt when missing or stale) and validating disjointness."""
        if not paths:
            raise ValueError("servable layer has no files")
        files = sorted((SpillFile.open(p) for p in paths), key=lambda f: f.min_id)
        if any(f.dim != files[0].dim or f.dtype != files[0].dtype for f in files):
            raise ValueError("servable files disagree on dim/dtype")
        indexes = [f.load_index(block_rows=block_rows, stats=stats) for f in files]
        file_min = np.array([f.min_id for f in files], dtype=np.uint64)
        file_max = np.array([f.max_id for f in files], dtype=np.uint64)
        if np.any(file_min[1:] <= file_max[:-1]):
            raise ValueError(
                "servable files have overlapping id ranges; "
                "run compact_spills (GraphStore.register_servable_layer) first"
            )
        nb = np.array([ix.num_blocks for ix in indexes], dtype=np.int64)
        block_base = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int64)
        return ServableLayer(
            files=files,
            indexes=indexes,
            file_min=file_min,
            file_max=file_max,
            block_base=block_base,
            num_rows=sum(f.num_rows for f in files),
            dim=files[0].dim,
            dtype=files[0].dtype,
            file_block_rows=np.array(
                [ix.block_rows for ix in indexes], dtype=np.int64
            ),
        )

    @staticmethod
    def from_store(
        store, layer: int, version: int | None = None, stats: IOStats | None = None
    ) -> "ServableLayer":
        """Open the servable view of one published version of ``layer``
        (default: the current version) from a ``GraphStore`` manifest —
        see ``GraphStore.publish_servable_layer`` /
        ``repro_torch.session.AtlasSession.publish``."""
        info = store.servable_version_info(layer, epoch=version)
        view = ServableLayer.open(
            info["files"], block_rows=info["block_rows"], stats=stats
        )
        view.epoch = int(info["epoch"])
        return view

    def close(self) -> None:
        """Drop the lazily-opened id-column and row mmaps (and their
        fds).  The view stays usable; mappings re-open on next use."""
        with self._id_lock:
            self._id_cols = None
            self._row_views = None

    @property
    def data_nbytes(self) -> int:
        """Total bytes of row data across the layer's files — what the
        zero-copy fast path would map (and, warm, what the OS page cache
        holds).  Used to auto-select the fast path when a version fits
        the serving memory budget."""
        return self.num_rows * self.dim * self.dtype.itemsize

    # ------------------------------------------------------------ lookup
    def locate_files(self, unique_ids: np.ndarray) -> np.ndarray:
        """Per-id index of the only file whose [min, max] id range can
        contain it, or -1 (a definitive miss without touching disk).
        One vectorised binary search over the sorted file bounds."""
        uids = np.asarray(unique_ids, dtype=np.uint64)
        f = np.searchsorted(self.file_max, uids, side="left").astype(np.int64)
        in_file = f < len(self.files)
        in_file[in_file] &= uids[in_file] >= self.file_min[f[in_file]]
        f[~in_file] = -1
        return f

    def locate(self, unique_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Map sorted unique vertex ids to (file index, global block key).

        Both are -1 where no file/block id-range can contain the id (a
        definitive miss without touching disk).  Ids inside a block's
        [min, max] range may still be absent — the gap is only visible in
        the block's id column, checked after the block is fetched.
        """
        uids = np.asarray(unique_ids, dtype=np.uint64)
        f = self.locate_files(uids)
        in_file = f >= 0
        gkey = np.full(len(uids), -1, dtype=np.int64)
        for fi in np.unique(f[in_file]).tolist():
            sel = f == fi
            b = self.indexes[fi].find_blocks(uids[sel])
            g = np.where(b >= 0, self.block_base[fi] + b, -1)
            gkey[sel] = g
        f[gkey < 0] = -1
        return f, gkey

    def file_ids(self, fi: int) -> np.ndarray:
        """The full sorted id column of file ``fi`` as a lazily-opened,
        memory-mapped view (one mmap per file, cached on the layer).
        Locked: a ``ServableLayer`` is shared across query threads."""
        with self._id_lock:
            if self._id_cols is None:
                self._id_cols = [None] * len(self.files)
            col = self._id_cols[fi]
            if col is None:
                col = self.files[fi].ids_mmap()
                self._id_cols[fi] = col
            return col

    def rows_mmap(self, fi: int, madvise_willneed: bool = False) -> np.ndarray:
        """The full ``[rows, dim]`` data section of file ``fi`` as a
        lazily-opened, memory-mapped view (one mapping per file, cached
        on the layer like ``file_ids``).  The zero-copy serving fast
        path fancy-indexes requested rows directly out of this view —
        warm pages are served from the OS page cache with no pread, no
        block decode, and no second in-process copy."""
        with self._id_lock:
            if self._row_views is None:
                self._row_views = [None] * len(self.files)
            view = self._row_views[fi]
            if view is None:
                view = self.files[fi].rows_mmap(
                    madvise_willneed=madvise_willneed
                )
                self._row_views[fi] = view
            return view

    def locate_rows(self, unique_ids: np.ndarray, f: np.ndarray) -> np.ndarray:
        """Absolute row position of each id within its file, or -1.

        ``f`` is the per-id file index from ``locate``.  One batched
        binary search per *file* touched (against the mmapped id column)
        instead of one per block — the serving hot path's row addressing.
        An id inside a block's [min, max] range but absent from the file
        shows up as -1 here without any block fetch."""
        uids = np.asarray(unique_ids, dtype=np.uint64)
        f = np.asarray(f, dtype=np.int64)
        rowpos = np.full(len(uids), -1, dtype=np.int64)
        for fi in np.unique(f[f >= 0]).tolist():
            sel = f == fi
            ids_col = self.file_ids(fi)
            want = uids[sel]
            pos = np.searchsorted(ids_col, want).astype(np.int64)
            ok = pos < len(ids_col)
            ok[ok] &= ids_col[pos[ok]] == want[ok]
            pos[~ok] = -1
            rowpos[sel] = pos
        return rowpos

    def read_block_rows_span(
        self, fi: int, b0: int, b1: int, stats: IOStats | None = None
    ) -> np.ndarray:
        """Rows of blocks ``[b0, b1)`` of file ``fi`` as ONE contiguous
        pread.  A file's data section is its sorted rows back to back, so
        consecutive blocks are physically adjacent — a run of missed
        blocks costs one syscall and one buffer instead of one per
        block.  The serving fast path gathers straight out of the
        returned span (``VertexQueryEngine.lookup``)."""
        idx = self.indexes[fi]
        r0 = b0 * idx.block_rows
        r1 = min(b1 * idx.block_rows, idx.num_rows)
        return self.files[fi].read_rows(r0, r1, stats=stats)

    def read_block_by_key(
        self, gkey: int, stats: IOStats | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        fi = int(np.searchsorted(self.block_base, gkey, side="right")) - 1
        b = int(gkey) - int(self.block_base[fi])
        return self.files[fi].read_block(self.indexes[fi], b, stats=stats)

    def read_blocks_by_keys(
        self,
        gkeys: np.ndarray,
        stats: IOStats | None = None,
        with_ids: bool = True,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fetch several blocks, opening each underlying file only once;
        with `gkeys` sorted (the query engine's miss list), the reads within
        a file proceed in ascending offset order — sequential I/O.

        ``with_ids=False`` skips the id-column pread per block (the tuple's
        ids slot is an empty array): the query engine resolves row
        positions against the file-level mmapped id columns, so fetching
        and caching per-block ids would only waste I/O and cache budget."""
        gkeys = np.asarray(gkeys, dtype=np.int64)
        fis = np.searchsorted(self.block_base, gkeys, side="right") - 1
        blocks: list = [None] * len(gkeys)
        no_ids = np.empty(0, dtype=np.uint64)
        for fi in np.unique(fis).tolist():
            sel = np.flatnonzero(fis == fi)
            f, idx = self.files[fi], self.indexes[fi]
            row_bytes = f.dim * f.dtype.itemsize
            with open(f.path, "rb") as fh:
                for j in sel.tolist():
                    b = int(gkeys[j]) - int(self.block_base[fi])
                    n = idx.rows_in_block(b)
                    if with_ids:
                        fh.seek(int(idx.id_off[b]))
                        id_buf = fh.read(n * 8)
                        ids = np.frombuffer(id_buf, dtype=np.uint64)
                        if stats is not None:
                            stats.add_read(len(id_buf))
                    else:
                        ids = no_ids
                    fh.seek(int(idx.data_off[b]))
                    data_buf = fh.read(n * row_bytes)
                    if stats is not None:
                        stats.add_read(len(data_buf))
                    blocks[j] = (
                        ids,
                        np.frombuffer(data_buf, dtype=f.dtype).reshape(n, f.dim),
                    )
        return blocks
