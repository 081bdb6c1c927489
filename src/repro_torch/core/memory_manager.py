"""Hot-store memory manager (paper §3.5).

Fixed-size slot array holding partial aggregation state for active
vertices, a vertex→slot map, and the eviction/reload dance against the
disk-backed cold store.  A vertex's partial state is only updatable while
HOT; COLD partials live in the cold store until reloaded.

All bookkeeping is array-native: the free-slot pool is a NumPy stack with
a top pointer, the current activation batch is hard-shielded via a
reusable boolean mask over the vertex id space, and the policy is driven
through its batch API (``add_many`` / ``update_many`` / ``remove_many``),
so one delivery sub-batch costs a constant number of NumPy calls
regardless of its size.  The chunk-level eviction shield arrives as a
boolean mask from the engine (no per-chunk Python sets).

Each call into the policy is a ``policy`` span of the tracer, named after
the call, and each move to or from the cold store a ``cold`` span
(``cold_put``, ``cold_take``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import orchestrator as ost
from repro_torch.core.eviction import EvictionPolicy
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.storage.coldstore import ColdStore


class HotStoreFullError(RuntimeError):
    pass


class MemoryManager:
    def __init__(
        self,
        num_slots: int,
        dim: int,
        dtype,
        orchestrator: Orchestrator,
        policy: EvictionPolicy,
        cold: ColdStore,
        tracer=NULL_TRACER,
    ):
        self.num_slots = num_slots
        self.dim = dim
        self.dtype = np.dtype(dtype)
        self.orch = orchestrator
        self.policy = policy
        self.cold = cold
        self.tracer = tracer
        self.hot = np.zeros((num_slots, dim), dtype=self.dtype)
        self.slot_of = np.full(orchestrator.num_vertices, -1, dtype=np.int64)
        self.vertex_in_slot = np.full(num_slots, -1, dtype=np.int64)
        # free-slot stack: pop from the top (end), so slot 0 is handed out
        # first, matching the historical list-based pool
        self._free = np.arange(num_slots - 1, -1, -1, dtype=np.int64)
        self._free_top = num_slots
        # reusable hard-shield mask for the batch currently being activated
        self._hard = np.zeros(orchestrator.num_vertices, dtype=bool)
        self.eviction_count = 0
        self.reload_count = 0
        self.peak_occupancy = 0

    # ---------------------------------------------------------- occupancy
    @property
    def occupancy(self) -> int:
        return self.num_slots - self._free_top

    # ------------------------------------------------------------- slots
    def _pop_slots(self, n: int) -> np.ndarray:
        self._free_top -= n
        return self._free[self._free_top : self._free_top + n][::-1].copy()

    def _push_slots(self, slots: np.ndarray) -> None:
        self._free[self._free_top : self._free_top + len(slots)] = slots
        self._free_top += len(slots)

    def _alloc_slots(self, n: int, shield_mask) -> np.ndarray:
        """Get n free slots, evicting via the policy if necessary.

        The hard shield (``self._hard``, the vertices being activated right
        now) may never be evicted; ``shield_mask`` (the current chunk's
        other destinations) is an anti-thrash shield that is relaxed when
        the store is too tight to honour it.
        """
        if n > self.num_slots:
            raise HotStoreFullError(
                f"batch needs {n} slots but hot store only has {self.num_slots};"
                " increase hot-store budget or reduce chunk size"
            )
        deficit = n - self._free_top
        if deficit > 0:
            exclude = (
                (self._hard, shield_mask) if shield_mask is not None else self._hard
            )
            with self.tracer.span("select_victims", "policy"):
                victims = self.policy.select_victims(deficit, exclude=exclude)
            if len(victims) < deficit:  # shield too broad: relax to hard-only
                with self.tracer.span("select_victims", "policy"):
                    victims = self.policy.select_victims(deficit, exclude=self._hard)
            if len(victims) < deficit:
                raise HotStoreFullError(
                    f"cannot evict {deficit} vertices (only {len(victims)}"
                    " candidates); hot store too small for this batch"
                )
            self._evict(np.asarray(victims, dtype=np.int64))
        return self._pop_slots(n)

    def _evict(self, victims: np.ndarray) -> None:
        slots = self.slot_of[victims]
        with self.tracer.span("cold_put", "cold"):
            self.cold.put(victims, self.hot[slots])
        with self.tracer.span("remove_many", "policy"):
            self.policy.remove_many(victims)
        self.orch.to_cold(victims)
        self.slot_of[victims] = -1
        self.vertex_in_slot[slots] = -1
        self._push_slots(slots)
        self.eviction_count += len(victims)

    # ----------------------------------------------------------- activate
    def activate(self, vertices: np.ndarray, chunk_shield=None) -> np.ndarray:
        """Ensure all `vertices` are HOT with assigned slots.

        `vertices` are unique destinations of the current delivery batch;
        states may be NOT_STARTED (assign zeroed slot), COLD (reload partial
        from cold store), or HOT (no-op).  The batch itself is hard-shielded
        from eviction; the rest of the chunk's destinations (`chunk_shield`,
        a boolean mask over vertex ids — a Python set also works for the
        scalar oracle path) are soft-shielded — evicting a vertex about to
        receive a message would thrash by definition.
        """
        states = self.orch.state[vertices]
        fresh = vertices[states == ost.NOT_STARTED]
        frozen = vertices[states == ost.COLD]
        need = len(fresh) + len(frozen)
        if need:
            self._hard[vertices] = True
            try:
                slots = self._alloc_slots(need, chunk_shield)
            finally:
                self._hard[vertices] = False
            k = len(fresh)
            if k:
                fslots = slots[:k]
                self.hot[fslots] = 0
                self.slot_of[fresh] = fslots
                self.vertex_in_slot[fslots] = fresh
                self.orch.to_hot(fresh)
                with self.tracer.span("add_many", "policy"):
                    self.policy.add_many(fresh, self.orch.pending(fresh))
            if len(frozen):
                cslots = slots[k:]
                with self.tracer.span("cold_take", "cold"):
                    self.hot[cslots] = self.cold.take(frozen)
                self.slot_of[frozen] = cslots
                self.vertex_in_slot[cslots] = frozen
                self.orch.to_hot(frozen)
                with self.tracer.span("add_many", "policy"):
                    self.policy.add_many(frozen, self.orch.pending(frozen))
                self.reload_count += len(frozen)
        self.peak_occupancy = max(self.peak_occupancy, self.occupancy)
        return self.slot_of[vertices]

    # ---------------------------------------------------------- aggregate
    def accumulate(
        self,
        vertices: np.ndarray,
        partial: np.ndarray,
        col_offset: int = 0,
        slots: np.ndarray | None = None,
    ) -> None:
        """hot[slot(v), off:off+w] += partial_v for unique vertices (all HOT).

        ``col_offset`` supports SAGE's concat layout: self features occupy
        columns [0, d), neighbor aggregates [d, 2d) (paper §4.3).  ``slots``
        may carry the assignment just returned by ``activate`` to skip the
        re-lookup.
        """
        if slots is None:
            slots = self.slot_of[vertices]
        if np.any(slots < 0):
            raise RuntimeError("accumulate() on vertex without a hot slot")
        width = partial.shape[1]
        self.hot[slots, col_offset : col_offset + width] += partial.astype(
            self.dtype, copy=False
        )

    def update_policy_scores(
        self, vertices: np.ndarray, old_pending: np.ndarray, new_pending: np.ndarray
    ) -> None:
        with self.tracer.span("update_many", "policy"):
            self.policy.update_many(vertices, old_pending, new_pending)

    # ----------------------------------------------------------- graduate
    def release_to(self, vertices: np.ndarray, grad) -> None:
        """Gather finalized rows straight into the graduation buffer
        (``grad.add_gather``) and free the slots — one fancy-indexed copy
        hot-store -> ring buffer, no intermediate row array."""
        slots = self.slot_of[vertices]
        grad.add_gather(vertices, self.hot, slots)
        self._free_released(vertices, slots)

    def _free_released(self, vertices: np.ndarray, slots: np.ndarray) -> None:
        with self.tracer.span("remove_many", "policy"):
            self.policy.remove_many(vertices)
        self.orch.to_completed(vertices)
        self.slot_of[vertices] = -1
        self.vertex_in_slot[slots] = -1
        self._push_slots(slots)
