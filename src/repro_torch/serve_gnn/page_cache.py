"""Sharded, memory-budgeted page cache of decoded spill blocks.

The serving read path fetches fixed-row *blocks* from sorted spill files
(storage/spill.py sidecar indexes).  Decoded blocks — the (ids, rows)
pair — are cached here so repeated lookups of warm vertices never touch
disk.  The cache is sharded by block key: each shard owns a disjoint key
subset with its own lock, LRU list, and byte budget, so concurrent
query threads contend only when they hash to the same shard.

Recency is tracked with the same array-native intrusive-DLL machinery the
delivery core's eviction policies use (``core.eviction.ArrayBucketList``
with a single bucket): touching or inserting a batch of blocks is one
``detach`` + ``append`` splice, eviction walks the list head-first
(oldest-first) until the shard is back under budget.

Counters: ``hits``/``misses`` (block granularity) plus an ``IOStats``
where ``bytes_read`` counts bytes served from cache and ``bytes_written``
counts bytes admitted into it.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.eviction import ArrayBucketList
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.storage.iostats import IOStats

Block = tuple[np.ndarray, np.ndarray]  # (ids u64 [n], rows [n, dim])


def _block_nbytes(block: Block) -> int:
    ids, rows = block
    return int(ids.nbytes + rows.nbytes)


class _Shard:
    def __init__(self, num_keys: int, budget_bytes: int):
        self.lock = threading.Lock()
        self.lru = ArrayBucketList(num_keys, max_score=0)
        self.blocks: dict[int, Block] = {}
        self.budget_bytes = budget_bytes
        self.bytes_used = 0

    def evict_to_budget(self) -> int:
        evicted = 0
        while self.bytes_used > self.budget_bytes and len(self.lru):
            victims = self.lru.walk_min(16)
            freed = []
            for key in victims.tolist():
                freed.append(key)
                self.bytes_used -= _block_nbytes(self.blocks.pop(key))
                if self.bytes_used <= self.budget_bytes:
                    break
            self.lru.detach(np.asarray(freed, dtype=np.int64))
            evicted += len(freed)
        return evicted


class ShardedPageCache:
    """LRU block cache under a global byte budget, split across shards.

    ``num_keys`` is the global block-key space (total blocks across the
    servable layer's files); keys are dense integers so the intrusive
    lists need no hashing.  The budget is divided evenly across shards —
    with block keys assigned round-robin (``key % num_shards``) a skewed
    workload still spreads its hot blocks over all shards.
    """

    def __init__(
        self,
        num_keys: int,
        budget_bytes: int,
        num_shards: int = 4,
        stats: IOStats | None = None,
        tracer=None,
        metrics=None,
        metrics_prefix: str = "serve.cache",
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.budget_bytes = int(budget_bytes)
        self.stats = stats if stats is not None else IOStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        per = max(1, self.budget_bytes // num_shards)
        self._shards = [_Shard(int(num_keys), per) for _ in range(num_shards)]
        self._counter_lock = threading.Lock()  # hits/misses/evictions
        self.hits = 0
        self.misses = 0
        self.evicted_blocks = 0
        # optional obs.MetricsRegistry export: hit/miss/eviction counters
        # plus resident-bytes/blocks gauges under `<prefix>.*`
        self._m_hits = self._m_misses = self._m_evicted = None
        self._m_resident_bytes = self._m_resident_blocks = None
        if metrics is not None:
            self.bind_metrics(metrics, prefix=metrics_prefix)

    def bind_metrics(self, registry, prefix: str = "serve.cache") -> None:
        """Mirror the cache counters into an ``obs.MetricsRegistry`` so
        runs that already snapshot a registry (``obs_report``,
        ``bench_serve`` JSON) see cache behavior without reaching into
        the cache object: ``<prefix>.hits|misses|evicted_blocks``
        counters and ``<prefix>.resident_bytes|resident_blocks``
        gauges, updated on every ``get_many``/``put_many``."""
        self._m_hits = registry.counter(f"{prefix}.hits")
        self._m_misses = registry.counter(f"{prefix}.misses")
        self._m_evicted = registry.counter(f"{prefix}.evicted_blocks")
        self._m_resident_bytes = registry.gauge(f"{prefix}.resident_bytes")
        self._m_resident_blocks = registry.gauge(f"{prefix}.resident_blocks")

    # -------------------------------------------------------------- read
    def get_many(self, keys: np.ndarray) -> list[Block | None]:
        """Fetch blocks for `keys`; None marks a miss.  Hits are touched
        (moved to MRU) per shard in one batched splice."""
        keys = np.asarray(keys, dtype=np.int64)
        tr = self.tracer
        if tr.enabled:
            tr.begin("cache_get", "serve")
        out: list[Block | None] = [None] * len(keys)
        hit_bytes = 0
        hits = 0
        shard_of = keys % self.num_shards
        for s in np.unique(shard_of).tolist():
            shard = self._shards[s]
            sel = np.flatnonzero(shard_of == s)
            with shard.lock:
                hit_keys = []
                for i in sel.tolist():
                    block = shard.blocks.get(int(keys[i]))
                    if block is not None:
                        out[i] = block
                        hit_keys.append(int(keys[i]))
                        hit_bytes += _block_nbytes(block)
                if hit_keys:
                    # touch: detach + re-append == batch move-to-MRU
                    ks = np.unique(np.asarray(hit_keys, dtype=np.int64))
                    shard.lru.detach(ks)
                    shard.lru.append(ks, np.zeros(len(ks), dtype=np.int64))
                    hits += len(hit_keys)
        with self._counter_lock:
            self.hits += hits
            self.misses += len(keys) - hits
        if self._m_hits is not None:
            self._m_hits.inc(hits)
            self._m_misses.inc(len(keys) - hits)
        if hit_bytes:
            self.stats.add_read(hit_bytes)
        if tr.enabled:
            tr.end("cache_get", "serve")
        return out

    # ------------------------------------------------------------- write
    def put_many(self, keys: np.ndarray, blocks: list[Block]) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        tr = self.tracer
        if tr.enabled:
            tr.begin("cache_put", "serve")
        shard_of = keys % self.num_shards
        admitted_bytes = 0
        for s in np.unique(shard_of).tolist():
            shard = self._shards[s]
            sel = np.flatnonzero(shard_of == s)
            with shard.lock:
                fresh = []
                for i in sel.tolist():
                    key = int(keys[i])
                    if key in shard.blocks:
                        continue  # racing insert: keep the resident copy
                    nbytes = _block_nbytes(blocks[i])
                    if nbytes > shard.budget_bytes:
                        continue  # would evict the whole shard for one block
                    shard.blocks[key] = blocks[i]
                    shard.bytes_used += nbytes
                    admitted_bytes += nbytes
                    fresh.append(key)
                if fresh:
                    ks = np.asarray(fresh, dtype=np.int64)
                    shard.lru.append(ks, np.zeros(len(ks), dtype=np.int64))
                evicted = shard.evict_to_budget()
            with self._counter_lock:
                self.evicted_blocks += evicted
            if self._m_evicted is not None and evicted:
                self._m_evicted.inc(evicted)
        if admitted_bytes:
            self.stats.add_write(admitted_bytes)
        if self._m_resident_bytes is not None:
            self._m_resident_bytes.set(float(self.resident_bytes))
            self._m_resident_blocks.set(float(self.resident_blocks))
        if tr.enabled:
            tr.end("cache_put", "serve")

    # ----------------------------------------------------------- queries
    @property
    def resident_blocks(self) -> int:
        return sum(len(s.blocks) for s in self._shards)

    @property
    def resident_bytes(self) -> int:
        return sum(s.bytes_used for s in self._shards)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate(),
            "resident_blocks": self.resident_blocks,
            "resident_bytes": self.resident_bytes,
            "evicted_blocks": self.evicted_blocks,
            **{f"io_{k}": v for k, v in self.stats.snapshot().items()},
        }
