"""Cold store: disk-backed tier for evicted partial aggregation state
(paper §3.5.3).

Implemented as a slot-file (np.memmap) + a vertex→slot map held as a
dynamically grown NumPy array, with the free slots as an array stack —
``put``/``take`` move whole eviction/reload batches with fancy indexing
instead of per-vertex dict operations, keeping the eviction hot path
array-native end to end.  Buffered I/O (mmap) is intentional — the paper
argues evicted vertices are *guaranteed* to be reloaded, so page-cache
reuse helps, unlike the single-pass feature stream which bypasses the
cache.

Reload/evict byte counters feed the Fig 6/7 ablations.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.storage.iostats import IOStats


class ColdStore:
    def __init__(
        self,
        path: str,
        dim: int,
        dtype=np.float32,
        initial_slots: int = 1024,
        stats: IOStats | None = None,
    ):
        self.path = path
        self.dim = dim
        self.dtype = np.dtype(dtype)
        self.stats = stats if stats is not None else IOStats()
        self._capacity = max(1, initial_slots)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._mm = np.memmap(
            path, dtype=self.dtype, mode="w+", shape=(self._capacity, dim)
        )
        # vertex id -> cold slot (-1 = not resident); grown on demand
        self._slot_of = np.full(self._capacity, -1, dtype=np.int64)
        # free-slot stack, popped from the top so slot 0 is used first
        self._free = np.arange(self._capacity - 1, -1, -1, dtype=np.int64)
        self._free_top = self._capacity
        self._resident = 0
        self.evict_count = 0
        self.reload_count = 0
        self.peak_resident = 0

    # ------------------------------------------------------------- sizing
    def _grow(self) -> None:
        new_cap = self._capacity * 2
        self._mm.flush()
        new_mm = np.memmap(
            self.path + ".grow", dtype=self.dtype, mode="w+", shape=(new_cap, self.dim)
        )
        new_mm[: self._capacity] = self._mm[:]
        del self._mm
        os.replace(self.path + ".grow", self.path)
        self._mm = new_mm
        new_free = np.empty(new_cap, dtype=np.int64)
        new_free[: self._free_top] = self._free[: self._free_top]
        fresh = np.arange(new_cap - 1, self._capacity - 1, -1, dtype=np.int64)
        new_free[self._free_top : self._free_top + len(fresh)] = fresh
        self._free = new_free
        self._free_top += len(fresh)
        self._capacity = new_cap

    def _ensure_map(self, max_vertex: int) -> None:
        if max_vertex < len(self._slot_of):
            return
        new_len = max(len(self._slot_of) * 2, max_vertex + 1)
        grown = np.full(new_len, -1, dtype=np.int64)
        grown[: len(self._slot_of)] = self._slot_of
        self._slot_of = grown

    # -------------------------------------------------------------- evict
    def put(self, vertex_ids: np.ndarray, rows: np.ndarray) -> None:
        """Spill partial states of unique `vertex_ids` (HOT -> COLD)."""
        vids = np.asarray(vertex_ids, dtype=np.int64)
        if not len(vids):
            return
        self._ensure_map(int(vids.max()))
        slots = self._slot_of[vids]
        missing = slots < 0
        n_miss = int(missing.sum())
        while self._free_top < n_miss:
            self._grow()
        if n_miss:
            self._free_top -= n_miss
            fresh = self._free[self._free_top : self._free_top + n_miss][::-1]
            slots[missing] = fresh
            self._slot_of[vids[missing]] = fresh
            self._resident += n_miss
        self._mm[slots] = np.asarray(rows, dtype=self.dtype)
        self.evict_count += len(vids)
        self.stats.add_write(len(vids) * self.dim * self.dtype.itemsize)
        self.peak_resident = max(self.peak_resident, self._resident)

    # ------------------------------------------------------------- reload
    def take(self, vertex_ids: np.ndarray) -> np.ndarray:
        """Reload partial states (COLD -> HOT) and free the cold slots."""
        vids = np.asarray(vertex_ids, dtype=np.int64)
        if not len(vids):
            return np.empty((0, self.dim), dtype=self.dtype)
        in_map = vids < len(self._slot_of)
        if not np.all(in_map):
            raise KeyError(int(vids[~in_map][0]))
        slots = self._slot_of[vids]
        if np.any(slots < 0):
            raise KeyError(int(vids[slots < 0][0]))
        out = np.array(self._mm[slots], dtype=self.dtype)
        self._slot_of[vids] = -1
        self._free[self._free_top : self._free_top + len(slots)] = slots
        self._free_top += len(slots)
        self._resident -= len(vids)
        self.reload_count += len(vids)
        self.stats.add_read(len(vids) * self.dim * self.dtype.itemsize)
        return out

    def contains(self, vertex_id: int) -> bool:
        v = int(vertex_id)
        return v < len(self._slot_of) and self._slot_of[v] >= 0

    @property
    def resident(self) -> int:
        return self._resident

    def close(self) -> None:
        self._mm.flush()
        del self._mm
