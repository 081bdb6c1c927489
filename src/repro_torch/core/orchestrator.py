"""Per-layer vertex state machine (paper §3.4).

Compact O(|V|) arrays: required message counts, received counts, and a
1-byte state per vertex.  Valid transitions only:

    NOT_STARTED -> HOT
    HOT         -> COLD | COMPLETED
    COLD        -> HOT
"""

from __future__ import annotations

import numpy as np

NOT_STARTED = np.uint8(0)
HOT = np.uint8(1)
COLD = np.uint8(2)
COMPLETED = np.uint8(3)

_STATE_NAMES = {0: "NOT_STARTED", 1: "HOT", 2: "COLD", 3: "COMPLETED"}


class Orchestrator:
    """Tracks per-vertex progress for the current layer."""

    def __init__(self, required: np.ndarray):
        self.num_vertices = len(required)
        self.required = np.asarray(required, dtype=np.int64)
        self.received = np.zeros(self.num_vertices, dtype=np.int64)
        self.state = np.full(self.num_vertices, NOT_STARTED, dtype=np.uint8)
        # span tracking (paper §4.5): first/last chunk index a vertex
        # receives a message in — measures how long partial state must live.
        self.first_touch = np.full(self.num_vertices, -1, dtype=np.int64)
        self.last_touch = np.full(self.num_vertices, -1, dtype=np.int64)
        # O(1) completion check: graduation calls to_completed once per
        # sub-batch on the layer tail, so completion is counter-tracked
        # instead of re-scanning the O(|V|) state array
        self._need_completed = int(np.count_nonzero(self.required > 0))
        self._num_completed = 0

    # ----------------------------------------------------------- queries
    def pending(self, vertices: np.ndarray) -> np.ndarray:
        return self.required[vertices] - self.received[vertices]

    def is_complete(self) -> bool:
        return self._num_completed >= self._need_completed

    def incomplete_vertices(self) -> np.ndarray:
        return np.nonzero((self.required > 0) & (self.state != COMPLETED))[0]

    # ------------------------------------------------------- transitions
    def _check(self, vertices: np.ndarray, allowed: tuple) -> None:
        s = self.state[vertices]
        ok = s == allowed[0]
        for a in allowed[1:]:
            ok |= s == a
        bad = ~ok
        if np.any(bad):
            v = np.asarray(vertices)[bad][0]
            raise RuntimeError(
                f"invalid transition for vertex {v} from "
                f"{_STATE_NAMES[int(self.state[v])]}"
            )

    def to_hot(self, vertices: np.ndarray) -> None:
        self._check(vertices, (NOT_STARTED, COLD))
        self.state[vertices] = HOT

    def to_cold(self, vertices: np.ndarray) -> None:
        self._check(vertices, (HOT,))
        self.state[vertices] = COLD

    def to_completed(self, vertices: np.ndarray) -> None:
        self._check(vertices, (HOT,))
        self.state[vertices] = COMPLETED
        self._num_completed += int(np.count_nonzero(self.required[vertices] > 0))

    # ---------------------------------------------------------- delivery
    def deliver(
        self, vertices: np.ndarray, counts: np.ndarray, chunk_index: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Record `counts` messages delivered to `vertices`.

        Returns ``(done_mask, old_pending, new_pending)`` in one call so
        the delivery loop can make a single batched eviction-policy update
        without re-querying pending counts before and after."""
        req = self.required[vertices]
        old_received = self.received[vertices]
        new_received = old_received + counts
        over = new_received > req
        if np.any(over):
            v = np.asarray(vertices)[over][0]
            raise RuntimeError(
                f"vertex {v} received {int(self.received[v] + counts[over][0])} "
                f"> required {self.required[v]} messages"
            )
        self.received[vertices] = new_received
        first = self.first_touch[vertices] < 0
        if np.any(first):
            self.first_touch[np.asarray(vertices)[first]] = chunk_index
        self.last_touch[vertices] = chunk_index
        return new_received == req, req - old_received, req - new_received

    # ------------------------------------------------------------ stats
    def span_stats(self) -> dict:
        touched = self.first_touch >= 0
        spans = (self.last_touch - self.first_touch)[touched]
        if len(spans) == 0:
            return {"mean_span": 0.0, "p95_span": 0.0, "max_span": 0}
        return {
            "mean_span": float(spans.mean()),
            "p95_span": float(np.percentile(spans, 95)),
            "max_span": int(spans.max()),
        }
