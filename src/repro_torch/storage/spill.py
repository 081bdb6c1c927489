"""Sorted spill files (paper §3.2, §3.7).

Embeddings graduate in arbitrary order; ATLAS never does a global external
sort.  Instead each range partition accumulates rows in a spill buffer,
sorts the buffer in memory by vertex ID, and flushes it as an immutable
*sorted spill file*.  The reader later merges the (few) spill files
overlapping a chunk's ID range on the fly ("merge-on-read", §3.3).

File format (single binary file, explicit reads so byte accounting is
exact):

    header: magic 'ATLS' | version u32 | n_rows u64 | dim u32 | dtype code u32
            | min_id u64 | max_id u64   (40 bytes)
    ids:    u64 [n_rows]               (sorted ascending)
    data:   dtype [n_rows, dim]

Each spill file carries a sidecar *block index* (``<path>.idx``) written at
spill time: the sorted rows are cut into fixed-size blocks and the index
records each block's min/max vertex id plus the byte offsets of its id and
row slices.  A point lookup is then a binary search over block bounds plus
one block-sized pread — no merge-on-read scan — which is what the serving
read path (repro_torch.serve_gnn) is built on.  The sidecar is fully derivable
from the data file: a missing, stale, or corrupt ``.idx`` is rebuilt
transparently (``SpillFile.load_index``).

    idx header: magic 'ATLX' | version u32 | block_rows u32 | dim u32
                | dtype code u32 | n_rows u64 | n_blocks u64
                | min_id u64 | max_id u64   (52 bytes)
    arrays:     block_min u64 [n_blocks] | block_max u64 [n_blocks]
                | id_off u64 [n_blocks] | data_off u64 [n_blocks]
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from repro_torch.storage.iostats import IOStats

_MAGIC = b"ATLS"
_VERSION = 1
_HEADER = struct.Struct("<4sIQIIQQ")  # magic, ver, n, dim, dtype, min, max

_IDX_MAGIC = b"ATLX"
_IDX_VERSION = 1
# magic, ver, block_rows, dim, dtype, n_rows, n_blocks, min_id, max_id
_IDX_HEADER = struct.Struct("<4sIIIIQQQQ")

DEFAULT_BLOCK_ROWS = 4096

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float16): 1,
    np.dtype(np.float64): 2,
    np.dtype("bfloat16") if "bfloat16" in np.sctypeDict else np.dtype(np.float16): 1,
}
_CODE_DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.float16), 2: np.dtype(np.float64)}


def _dtype_code(dtype: np.dtype) -> int:
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        return 0
    if dtype == np.float16:
        return 1
    if dtype == np.float64:
        return 2
    raise ValueError(f"unsupported spill dtype {dtype}")


@dataclasses.dataclass(frozen=True)
class BlockIndex:
    """Sidecar index of one spill file: fixed-row blocks with id bounds.

    ``block_min``/``block_max`` are sorted and pairwise disjoint (the data
    file's ids are sorted and unique within a file), so locating the block
    that may contain a vertex id is one ``searchsorted``; ``id_off``/
    ``data_off`` give the byte offsets of each block's id and row slices so
    the block is fetched with two preads and nothing else.
    """

    block_rows: int
    num_rows: int
    dim: int
    dtype: np.dtype
    min_id: int
    max_id: int
    block_min: np.ndarray  # u64 [n_blocks], first id of each block
    block_max: np.ndarray  # u64 [n_blocks], last id of each block
    id_off: np.ndarray  # u64 [n_blocks], byte offset of the block's ids
    data_off: np.ndarray  # u64 [n_blocks], byte offset of the block's rows

    @property
    def num_blocks(self) -> int:
        return len(self.block_min)

    def rows_in_block(self, b: int) -> int:
        return min(self.block_rows, self.num_rows - b * self.block_rows)

    @staticmethod
    def from_ids(
        ids: np.ndarray, block_rows: int, dim: int, dtype: np.dtype
    ) -> "BlockIndex":
        """Compute the index from the (sorted) id column — used both at
        spill-write time (ids already in memory) and for rebuilds."""
        dtype = np.dtype(dtype)
        n = len(ids)
        block_rows = max(1, int(block_rows))
        starts = np.arange(0, n, block_rows, dtype=np.int64)
        ends = np.minimum(starts + block_rows, n)
        row_bytes = dim * dtype.itemsize
        return BlockIndex(
            block_rows=block_rows,
            num_rows=n,
            dim=dim,
            dtype=dtype,
            min_id=int(ids[0]) if n else 0,
            max_id=int(ids[-1]) if n else 0,
            block_min=ids[starts].astype(np.uint64) if n else np.empty(0, np.uint64),
            block_max=ids[ends - 1].astype(np.uint64) if n else np.empty(0, np.uint64),
            id_off=(_HEADER.size + starts * 8).astype(np.uint64),
            data_off=(_HEADER.size + n * 8 + starts * row_bytes).astype(np.uint64),
        )

    def save(self, path: str, stats: IOStats | None = None) -> None:
        header = _IDX_HEADER.pack(
            _IDX_MAGIC,
            _IDX_VERSION,
            self.block_rows,
            self.dim,
            _dtype_code(self.dtype),
            self.num_rows,
            self.num_blocks,
            self.min_id,
            self.max_id,
        )
        payload = b"".join(
            a.astype(np.uint64).tobytes()
            for a in (self.block_min, self.block_max, self.id_off, self.data_off)
        )
        tmp = path + ".tmp"
        # no fsync: the sidecar is derived state, rebuilt from the (fsynced)
        # data file if lost — keeps the spill writer's critical path cheap
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
        os.replace(tmp, path)
        if stats is not None:
            stats.add_write(len(header) + len(payload))

    @staticmethod
    def load(path: str, stats: IOStats | None = None) -> "BlockIndex":
        with open(path, "rb") as f:
            raw = f.read()
        if len(raw) < _IDX_HEADER.size:
            raise ValueError(f"{path}: truncated block index (no header)")
        magic, ver, block_rows, dim, code, n_rows, n_blocks, min_id, max_id = (
            _IDX_HEADER.unpack_from(raw)
        )
        if magic != _IDX_MAGIC:
            raise ValueError(f"{path}: bad block-index magic {magic!r}")
        if ver != _IDX_VERSION:
            raise ValueError(
                f"{path}: block-index version {ver} (expected {_IDX_VERSION})"
            )
        if code not in _CODE_DTYPES:
            raise ValueError(f"{path}: unknown block-index dtype code {code}")
        expected = _IDX_HEADER.size + 4 * 8 * n_blocks
        if len(raw) != expected:
            raise ValueError(
                f"{path}: truncated block index ({len(raw)} bytes, expected {expected})"
            )
        arrays = np.frombuffer(raw, dtype=np.uint64, offset=_IDX_HEADER.size)
        arrays = arrays.reshape(4, n_blocks)
        if stats is not None:
            stats.add_read(len(raw))
        return BlockIndex(
            block_rows=block_rows,
            num_rows=n_rows,
            dim=dim,
            dtype=_CODE_DTYPES[code],
            min_id=min_id,
            max_id=max_id,
            block_min=arrays[0],
            block_max=arrays[1],
            id_off=arrays[2],
            data_off=arrays[3],
        )

    def matches(self, spill: "SpillFile") -> bool:
        """Staleness check against the data file's header: a rewritten data
        file (different rows/shape/bounds) invalidates the sidecar."""
        return (
            self.num_rows == spill.num_rows
            and self.dim == spill.dim
            and self.dtype == spill.dtype
            and self.min_id == spill.min_id
            and self.max_id == spill.max_id
        )

    def find_blocks(self, ids: np.ndarray) -> np.ndarray:
        """For each query id, the index of the only block whose [min, max]
        range can contain it, or -1.  One vectorised binary search."""
        ids = np.asarray(ids, dtype=np.uint64)
        b = np.searchsorted(self.block_min, ids, side="right").astype(np.int64) - 1
        valid = b >= 0
        valid[valid] &= ids[valid] <= self.block_max[b[valid]]
        b[~valid] = -1
        return b


def write_spill(
    path: str,
    ids: np.ndarray,
    rows: np.ndarray,
    stats: IOStats | None = None,
    presorted: bool = False,
    block_rows: int | None = DEFAULT_BLOCK_ROWS,
    scratch: tuple[np.ndarray, np.ndarray] | None = None,
    durability: str = "fsync",
) -> "SpillFile":
    """Sort (ids, rows) by id and write one spill file atomically.

    ``scratch`` is an optional caller-owned ``(ids_buf, rows_buf)`` pair
    the sorted copy is gathered into (``np.take(..., out=...)``), so a
    high-frequency writer (the layer tail's per-partition flusher) reuses
    one arena instead of allocating two fresh arrays per spill.

    ``durability`` splits serialization from persistence:

    * ``"fsync"`` (default) — flush + fsync before the atomic rename, so
      the published file is durable the moment this returns.
    * ``"deferred"`` — serialize and rename only; the caller owns
      durability and must group-commit the file (and its directory)
      before any manifest references it — see
      ``repro_torch.storage.io_scheduler.WritebackIOScheduler.barrier``.
    """
    if durability not in ("fsync", "deferred"):
        raise ValueError(
            f"unknown durability {durability!r} (want 'fsync'|'deferred')"
        )
    ids = np.asarray(ids, dtype=np.uint64)
    rows = np.ascontiguousarray(rows)
    if rows.ndim != 2 or len(ids) != len(rows):
        raise ValueError("rows must be [n, dim] matching ids")
    if not presorted:
        order = np.argsort(ids, kind="stable")
        n = len(ids)
        if (
            scratch is not None
            and len(scratch[0]) >= n
            and len(scratch[1]) >= n
            and scratch[0].dtype == ids.dtype
            and scratch[1].dtype == rows.dtype
            and scratch[1].shape[1:] == rows.shape[1:]
        ):
            s_ids, s_rows = scratch[0][:n], scratch[1][:n]
            np.take(ids, order, out=s_ids, mode="clip")
            np.take(rows, order, axis=0, out=s_rows, mode="clip")
            ids, rows = s_ids, s_rows
        else:
            ids, rows = ids[order], rows[order]
    n, dim = rows.shape
    header = _HEADER.pack(
        _MAGIC,
        _VERSION,
        n,
        dim,
        _dtype_code(rows.dtype),
        int(ids[0]) if n else 0,
        int(ids[-1]) if n else 0,
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(ids.tobytes())
        f.write(rows.tobytes())
        if durability == "fsync":
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic publish: readers never see partial files
    if stats is not None:
        stats.add_write(len(header) + ids.nbytes + rows.nbytes)
    if block_rows is not None:
        # data file is already published: a crash before the sidecar lands
        # just means a rebuild on first serve-side open
        idx = BlockIndex.from_ids(ids, block_rows, dim, rows.dtype)
        idx.save(path + ".idx", stats=stats)
    return SpillFile(
        path=path,
        num_rows=n,
        dim=dim,
        dtype=rows.dtype,
        min_id=int(ids[0]) if n else 0,
        max_id=int(ids[-1]) if n else 0,
    )


@dataclasses.dataclass(frozen=True)
class SpillFile:
    """Descriptor of one immutable sorted spill file.

    Descriptors are tiny; file handles are opened lazily per read so open-fd
    count stays bounded (paper §3.3).
    """

    path: str
    num_rows: int
    dim: int
    dtype: np.dtype
    min_id: int
    max_id: int

    @staticmethod
    def open(path: str) -> "SpillFile":
        with open(path, "rb") as f:
            raw = f.read(_HEADER.size)
        if len(raw) < _HEADER.size:
            raise ValueError(f"{path}: truncated spill file (no header)")
        magic, ver, n, dim, code, min_id, max_id = _HEADER.unpack(raw)
        if magic != _MAGIC:
            raise ValueError(f"{path}: bad spill magic {magic!r}")
        if ver != _VERSION:
            raise ValueError(f"{path}: spill version {ver} (expected {_VERSION})")
        if code not in _CODE_DTYPES:
            raise ValueError(f"{path}: unknown spill dtype code {code}")
        expected = _HEADER.size + n * 8 + n * dim * _CODE_DTYPES[code].itemsize
        actual = os.path.getsize(path)
        if actual < expected:
            raise ValueError(
                f"{path}: truncated spill file ({actual} bytes, expected {expected})"
            )
        return SpillFile(
            path=path,
            num_rows=n,
            dim=dim,
            dtype=_CODE_DTYPES[code],
            min_id=min_id,
            max_id=max_id,
        )

    def _offsets(self) -> tuple[int, int]:
        ids_off = _HEADER.size
        data_off = ids_off + self.num_rows * 8
        return ids_off, data_off

    def ids_mmap(self) -> np.ndarray:
        """Read-only memory-mapped view of the sorted id column.

        Pages fault in on demand and live in the OS page cache, so the
        serving hot path can binary-search a whole file's ids without a
        read syscall per lookup.  The mapping holds the file open: on
        POSIX a concurrently unlinked file keeps serving until the view is
        dropped."""
        return np.memmap(
            self.path,
            dtype=np.uint64,
            mode="r",
            offset=_HEADER.size,
            shape=(self.num_rows,),
        )

    def rows_mmap(self, madvise_willneed: bool = False) -> np.ndarray:
        """Read-only memory-mapped ``[num_rows, dim]`` view of the data
        section — the zero-copy serving fast path gathers requested rows
        straight out of this view with one fancy index, no block decode
        or cache copy.  Like ``ids_mmap``, pages fault in on demand and
        the mapping keeps the file alive across a concurrent unlink.

        ``madvise_willneed`` asks the kernel to start readahead on the
        whole mapping (``MADV_WILLNEED``) where the platform supports
        it — a warm-up hint for versions expected to be served hot."""
        _, data_off = self._offsets()
        view = np.memmap(
            self.path,
            dtype=self.dtype,
            mode="r",
            offset=data_off,
            shape=(self.num_rows, self.dim),
        )
        if madvise_willneed:
            try:
                import mmap as _mmap

                view._mmap.madvise(_mmap.MADV_WILLNEED)  # type: ignore[attr-defined]
            except (AttributeError, ValueError, OSError):
                pass  # platform without madvise: the hint is best-effort
        return view

    def read_ids(self, stats: IOStats | None = None) -> np.ndarray:
        ids_off, _ = self._offsets()
        with open(self.path, "rb") as f:
            f.seek(ids_off)
            buf = f.read(self.num_rows * 8)
        if stats is not None:
            stats.add_read(len(buf))
        return np.frombuffer(buf, dtype=np.uint64)

    def read_rows(
        self, lo_row: int, hi_row: int, stats: IOStats | None = None
    ) -> np.ndarray:
        """Row slice [lo_row, hi_row) by position: one contiguous pread,
        no id-column read (callers that already hold the ids use this)."""
        _, data_off = self._offsets()
        row_bytes = self.dim * self.dtype.itemsize
        with open(self.path, "rb") as f:
            f.seek(data_off + lo_row * row_bytes)
            buf = f.read((hi_row - lo_row) * row_bytes)
        if stats is not None:
            stats.add_read(len(buf))
        return np.frombuffer(buf, dtype=self.dtype).reshape(hi_row - lo_row, self.dim)

    def read_id_range(
        self, start_id: int, end_id: int, stats: IOStats | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Rows with start_id <= id < end_id, via binary search on the sorted
        id column — one contiguous pread per spill file (paper §3.3)."""
        if self.num_rows == 0 or start_id > self.max_id or end_id <= self.min_id:
            return (
                np.empty(0, dtype=np.uint64),
                np.empty((0, self.dim), dtype=self.dtype),
            )
        ids = self.read_ids(stats)
        lo = int(np.searchsorted(ids, start_id, side="left"))
        hi = int(np.searchsorted(ids, end_id, side="left"))
        if hi <= lo:
            return (
                np.empty(0, dtype=np.uint64),
                np.empty((0, self.dim), dtype=self.dtype),
            )
        return ids[lo:hi], self.read_rows(lo, hi, stats)

    def read_all(self, stats: IOStats | None = None) -> tuple[np.ndarray, np.ndarray]:
        return self.read_id_range(self.min_id, self.max_id + 1, stats)

    # ------------------------------------------------------- block access
    @property
    def index_path(self) -> str:
        return self.path + ".idx"

    def load_index(
        self,
        block_rows: int = DEFAULT_BLOCK_ROWS,
        stats: IOStats | None = None,
        rebuild: bool = True,
    ) -> BlockIndex:
        """Load the sidecar block index, transparently rebuilding it from
        the data file when missing, corrupt, or stale.  ``block_rows`` only
        applies to a rebuild; a valid sidecar keeps its own block size."""
        try:
            idx = BlockIndex.load(self.index_path, stats=stats)
            if idx.matches(self):
                return idx
        except (FileNotFoundError, ValueError):
            pass
        if not rebuild:
            raise ValueError(f"{self.index_path}: missing or stale block index")
        idx = BlockIndex.from_ids(self.read_ids(stats), block_rows, self.dim, self.dtype)
        idx.save(self.index_path, stats=stats)
        return idx

    def read_block(
        self, idx: BlockIndex, block: int, stats: IOStats | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """One block's (ids, rows) via two preads at indexed offsets."""
        n = idx.rows_in_block(block)
        row_bytes = self.dim * self.dtype.itemsize
        with open(self.path, "rb") as f:
            f.seek(int(idx.id_off[block]))
            id_buf = f.read(n * 8)
            f.seek(int(idx.data_off[block]))
            data_buf = f.read(n * row_bytes)
        if stats is not None:
            stats.add_read(len(id_buf))
            stats.add_read(len(data_buf))
        ids = np.frombuffer(id_buf, dtype=np.uint64)
        rows = np.frombuffer(data_buf, dtype=self.dtype).reshape(n, self.dim)
        return ids, rows


@dataclasses.dataclass
class SpillSet:
    """All spill files of one logical tensor (one layer's embeddings),
    indexed by (min_id, max_id) and sorted by min_id for merge-on-read."""

    files: list[SpillFile] = dataclasses.field(default_factory=list)

    def add(self, f: SpillFile) -> None:
        self.files.append(f)
        self.files.sort(key=lambda s: s.min_id)

    def overlapping(self, start_id: int, end_id: int) -> list[SpillFile]:
        return [
            f
            for f in self.files
            if f.num_rows and f.min_id < end_id and f.max_id >= start_id
        ]

    def read_id_range(
        self, start_id: int, end_id: int, stats: IOStats | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Merge-on-read: concatenate overlapping files' row ranges and sort
        by vertex ID in memory (small: one chunk's worth)."""
        parts = [
            f.read_id_range(start_id, end_id, stats)
            for f in self.overlapping(start_id, end_id)
        ]
        parts = [(i, r) for i, r in parts if len(i)]
        if not parts:
            dim = self.files[0].dim if self.files else 0
            dtype = self.files[0].dtype if self.files else np.float32
            return np.empty(0, dtype=np.uint64), np.empty((0, dim), dtype=dtype)
        ids = np.concatenate([p[0] for p in parts])
        rows = np.concatenate([p[1] for p in parts])
        order = np.argsort(ids, kind="stable")
        return ids[order], rows[order]

    def total_rows(self) -> int:
        return sum(f.num_rows for f in self.files)

    def delete_all(self) -> None:
        for f in self.files:
            for path in (f.path, f.index_path):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
        self.files.clear()
