"""Batched vertex-embedding query engine over a servable layer.

A request is an arbitrary array of vertex ids (duplicates allowed, any
order).  The engine deduplicates and sorts the ids, maps them to global
block keys with two binary searches (file bounds, then the file's block
bounds — no id-column scan), resolves every id's row position with one
batched binary search per touched *file* against that file's mmapped id
column, consults the page cache, and coalesces the misses into block
reads issued in ascending block order, i.e. sequential within each
file.  Runs of missed blocks that are physically contiguous (consecutive
block keys in one file) collapse into a single span pread and a single
fancy-index gather for every requested row they cover — no per-block
syscall, buffer, or scatter on a cold range scan (``coalesce=False``
keeps the per-block path as the bit-identity oracle).  Rows come back in
request order, bit-identical to the rows ``spills_to_dense`` would
materialise for the same spill set.

``fast_path=True`` switches the row fetch to the **zero-copy mmap
path**: requested rows are fancy-index gathered straight out of each
touched file's memory-mapped data section, so the OS page cache *is*
the cache — no block decode, no ``ShardedPageCache`` copy, no pread
once pages are resident (``madvise(MADV_WILLNEED)`` primes readahead
where available).  It serves byte-identical rows to the default
page-cache path, which stays as the bit-identity oracle;
``repro_torch.session.AtlasSession.reader(fast_path="auto")`` selects it
automatically when a version's compact files fit the serving budget.

Ids absent from the layer raise ``KeyError`` — absence is detected for
free: either no file/block id-range covers the id (no I/O at all), or
the file's id column has a gap where the id would sort, caught before
any block is fetched.

Vertex ID namespace: a store built with ``GraphStore.create(order=...)``
stores rows under *internal* (storage-order) ids while callers speak
*external* (original) ids.  Pass ``id_map`` (the store's mmapped
``new_of_old`` sidecar, external → internal) and requests are translated
up front — one bounds check plus one fancy-index gather against the mmap
— before the existing searchsorted path, so published embeddings stay
queryable by the caller's ids regardless of physical layout.  With
``id_map=None`` (unordered stores) translation is identity-free: the
request array is used as-is.  ``id_unmap`` (``old_of_new``) is only
consulted on the error path, to name missing ids in the caller's
namespace.  ``repro_torch.session.AtlasSession.reader`` wires both
automatically.

Threading model: the shared tier is the (lock-sharded) page cache; a
``VertexQueryEngine`` is a cheap per-thread view — instantiate one per
query thread over the same ``ServableLayer`` and cache.  A single engine
used from several threads still returns correct rows, but its counters
(``queries``/``rows_served``/``blocks_read``/``last_blocks_read``) are
unsynchronized and would race.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve_gnn.page_cache import ShardedPageCache
from repro_torch.serve_gnn.servable import ServableLayer
from repro_torch.storage.iostats import IOStats


class VertexQueryEngine:
    def __init__(
        self,
        layer: ServableLayer,
        cache: ShardedPageCache | None = None,
        stats: IOStats | None = None,
        coalesce: bool = True,
        tracer=None,
        id_map: np.ndarray | None = None,
        id_unmap: np.ndarray | None = None,
        fast_path: bool = False,
        madvise: bool = True,
    ):
        self.layer = layer
        self.cache = cache
        self.stats = stats if stats is not None else IOStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.coalesce = coalesce  # span-read + single-gather fast path
        # zero-copy mmap path: gather rows straight out of the per-file
        # data mmaps (OS page cache IS the cache) instead of decoding
        # blocks into the ShardedPageCache; madvise asks for readahead
        # on first touch of each file's mapping
        self.fast_path = bool(fast_path)
        self.madvise = bool(madvise)
        # external -> internal id translation (None = identity namespace);
        # id_unmap is the inverse, used only to report missing ids in the
        # caller's namespace
        self.id_map = id_map
        self.id_unmap = id_unmap
        self.queries = 0
        self.rows_served = 0
        self.blocks_read = 0  # cumulative disk block fetches
        self.last_blocks_read = 0  # disk block fetches of the last lookup
        self.span_reads = 0  # coalesced preads issued for missed blocks
        self.coalesced_blocks = 0  # blocks covered by multi-block spans
        self.mmap_gathers = 0  # per-file fancy-index gathers (fast path)

    # ------------------------------------------------------------ lookup
    def lookup(self, vertex_ids: np.ndarray) -> np.ndarray:
        """Rows for `vertex_ids` (any order, duplicates fine), in request
        order, dtype = the layer's storage dtype."""
        tr = self.tracer
        if not tr.enabled:
            return self._lookup(vertex_ids)
        with tr.span("lookup", "serve"):
            return self._lookup(vertex_ids)

    def _lookup(self, vertex_ids: np.ndarray) -> np.ndarray:
        q = np.asarray(vertex_ids, dtype=np.uint64).ravel()
        self.queries += 1
        self.last_blocks_read = 0
        if len(q) == 0:
            return np.empty((0, self.layer.dim), dtype=self.layer.dtype)
        if self.id_map is not None:
            # external -> internal: translation preserves positions, so
            # everything downstream (dedup, inverse gather) is unchanged
            oob = q >= np.uint64(len(self.id_map))
            if np.any(oob):
                self._raise_missing(np.unique(q[oob]), external=True)
            q = np.asarray(self.id_map[q], dtype=np.uint64)
        uids, inv = np.unique(q, return_inverse=True)
        if self.fast_path:
            out = self._lookup_mmap(uids)
            self.rows_served += len(q)
            return out[inv]
        f, gkey = self.layer.locate(uids)
        if np.any(gkey < 0):
            self._raise_missing(uids[gkey < 0])

        # row addressing is resolved once, batched per *file*, against the
        # mmapped id columns: absolute row -> position within the id's
        # block, so the per-block loop below is a bare fancy-index scatter
        # (the old path re-ran searchsorted + bounds checks per block)
        rowpos = self.layer.locate_rows(uids, f)
        if np.any(rowpos < 0):
            self._raise_missing(uids[rowpos < 0])
        local = rowpos - (gkey - self.layer.block_base[f]) * (
            self.layer.file_block_rows[f]
        )

        # uids are sorted and files/blocks are id-ordered, so gkey is
        # non-decreasing: each needed block owns one contiguous uid slice
        starts = np.flatnonzero(np.r_[True, gkey[1:] != gkey[:-1]])
        ends = np.r_[starts[1:], len(gkey)]
        need_keys = gkey[starts]
        blocks: list = [None] * len(need_keys)
        if self.cache is not None:
            blocks = self.cache.get_many(need_keys)
        miss = np.flatnonzero(np.asarray([b is None for b in blocks]))
        out = np.empty((len(uids), self.layer.dim), dtype=self.layer.dtype)
        scattered = np.zeros(len(need_keys), dtype=bool)
        if len(miss):
            self.last_blocks_read = len(miss)
            self.blocks_read += len(miss)
            with self.tracer.span("serve_fetch", "read"):
                if self.coalesce:
                    self._fetch_coalesced(
                        miss, need_keys, f[starts], starts, ends, gkey,
                        local, blocks, out, scattered,
                    )
                else:
                    # oracle path: one fetch + one scatter per missed block
                    fetched = self.layer.read_blocks_by_keys(
                        need_keys[miss], stats=self.stats, with_ids=False
                    )
                    for i, blk in zip(miss.tolist(), fetched):
                        blocks[i] = blk
            if self.cache is not None:
                self.cache.put_many(
                    need_keys[miss], [blocks[i] for i in miss.tolist()]
                )

        # cache hits (and, on the oracle path, the fetched blocks): one
        # fancy-index scatter per block
        for j in np.flatnonzero(~scattered).tolist():
            lo, hi = starts[j], ends[j]
            out[lo:hi] = blocks[j][1][local[lo:hi]]
        self.rows_served += len(q)
        return out[inv]

    def _lookup_mmap(self, uids: np.ndarray) -> np.ndarray:
        """Zero-copy fast path: rows for sorted unique ``uids``.

        Addressing reuses the oracle path's machinery — one binary
        search over file bounds, one batched binary search per touched
        file against its mmapped id column — but the rows come straight
        out of the per-file data mmaps with one fancy-index gather per
        file: no block decode, no ``ShardedPageCache`` copy, no pread
        syscalls once the pages are resident.  Byte-for-byte the same
        rows as the page-cache path (the mapping views the identical
        on-disk bytes the block preads return)."""
        f = self.layer.locate_files(uids)
        if np.any(f < 0):
            self._raise_missing(uids[f < 0])
        rowpos = self.layer.locate_rows(uids, f)
        if np.any(rowpos < 0):
            self._raise_missing(uids[rowpos < 0])
        out = np.empty((len(uids), self.layer.dim), dtype=self.layer.dtype)
        for fi in np.unique(f).tolist():
            sel = f == fi
            view = self.layer.rows_mmap(fi, madvise_willneed=self.madvise)
            out[sel] = view[rowpos[sel]]
            self.mmap_gathers += 1
        return out

    def _fetch_coalesced(
        self, miss, need_keys, need_f, starts, ends, gkey, local,
        blocks, out, scattered,
    ) -> None:
        """Fetch missed blocks as contiguous spans and gather their rows.

        A span is a maximal run of missed blocks with consecutive global
        keys in one file — physically adjacent on disk, so the span is
        ONE pread, and because consecutive need_keys own adjacent uid
        slices, every requested row it covers lands in ``out`` with ONE
        fancy-index gather (a cold range scan does no per-block work at
        all).  Per-block copies are sliced out only for the page cache,
        which must own its entries (a view would pin the whole span
        buffer against the cache's byte budget)."""
        brk = np.flatnonzero(
            (np.diff(miss) != 1)
            | (np.diff(need_keys[miss]) != 1)
            | (np.diff(need_f[miss]) != 0)
        )
        bounds = np.r_[0, brk + 1, len(miss)]
        no_ids = np.empty(0, dtype=np.uint64)
        for s in range(len(bounds) - 1):
            j0 = int(miss[bounds[s]])
            j1 = int(miss[bounds[s + 1] - 1])
            fi = int(need_f[j0])
            base = int(self.layer.block_base[fi])
            b0 = int(need_keys[j0]) - base
            b1 = int(need_keys[j1]) - base + 1
            span = self.layer.read_block_rows_span(fi, b0, b1, stats=self.stats)
            bw = int(self.layer.file_block_rows[fi])
            lo, hi = int(starts[j0]), int(ends[j1])
            pos = (gkey[lo:hi] - int(need_keys[j0])) * bw + local[lo:hi]
            out[lo:hi] = span[pos]
            scattered[j0 : j1 + 1] = True
            self.span_reads += 1
            if b1 - b0 > 1:
                self.coalesced_blocks += b1 - b0
            if self.cache is not None:
                idx = self.layer.indexes[fi]
                for j in range(j0, j1 + 1):
                    off = (j - j0) * bw
                    n = idx.rows_in_block(b0 + (j - j0))
                    blocks[j] = (no_ids, span[off : off + n].copy())

    def _raise_missing(self, ids: np.ndarray, external: bool = False) -> None:
        if not external and self.id_unmap is not None:
            # report internal misses in the caller's (external) namespace
            ids = np.sort(np.asarray(self.id_unmap[ids]))
        sample = ", ".join(str(int(i)) for i in ids[:8])
        raise KeyError(
            f"{len(ids)} vertex id(s) not present in servable layer "
            f"(first: {sample})"
        )

    # ----------------------------------------------------------- metrics
    def snapshot(self) -> dict:
        rec = {
            "queries": self.queries,
            "external_ids": self.id_map is not None,
            "fast_path": self.fast_path,
            "rows_served": self.rows_served,
            "blocks_read": self.blocks_read,
            "span_reads": self.span_reads,
            "coalesced_blocks": self.coalesced_blocks,
            "mmap_gathers": self.mmap_gathers,
            **{f"io_{k}": v for k, v in self.stats.snapshot().items()},
        }
        if self.cache is not None:
            rec["cache"] = self.cache.snapshot()
        return rec
