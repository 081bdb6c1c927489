"""Eviction policies for the hot store (paper §3.5.2).

ATLAS's policy is *minimum-pending-messages*: evict the vertices with the
fewest messages still outstanding — they are closest to completion, so the
next reload is likely their last, minimising evict→reload churn.

Two implementations live side by side behind the same interface:

* ``python`` — the original scalar structures (``OrderedDict`` buckets,
  swap-remove lists).  Kept as the correctness oracle and for the
  ablation harness.
* ``array`` — NumPy intrusive doubly-linked bucket lists keyed by pending
  count: ``nxt``/``prv``/``score`` arrays over the vertex id space, with
  per-score ``head``/``tail``/``count`` arrays.  All bookkeeping is done
  with batch operations (``add_many`` / ``update_many`` / ``remove_many``)
  so the engine's per-chunk policy maintenance is a handful of NumPy calls
  instead of O(#destinations) Python dict operations.  Batch detach from
  the linked lists handles adjacent victims by pairing run starts with run
  ends via one lexsort over (bucket, append-seq) — no pointer chasing —
  and batch append splices one pre-linked chain per distinct score.

Both implementations produce *identical victim sets* for identical
operation sequences (within-bucket FIFO order is preserved exactly), which
tests/test_delivery_core.py asserts.  LRU and Random are the ablation
baselines (Fig 7).

``select_victims`` accepts the eviction shield as a Python set, a boolean
mask over vertex ids, or a tuple of such masks (hard shield, chunk
shield) — masks are what the batch delivery path passes so no per-chunk
sets are ever materialised.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

NIL = -1


# --------------------------------------------------------------------------
# Exclusion-shield normalisation: set | bool-mask | tuple of either
# --------------------------------------------------------------------------


def _scalar_contains(exclude):
    """Per-vertex membership test for the scalar (python) policies."""
    if exclude is None:
        return lambda v: False
    if isinstance(exclude, np.ndarray):
        return lambda v: bool(exclude[v])
    if isinstance(exclude, tuple):
        tests = [_scalar_contains(e) for e in exclude]
        return lambda v: any(t(v) for t in tests)
    return lambda v: v in exclude  # set / dict-keys


def _excluded_mask(exclude, members: np.ndarray) -> np.ndarray:
    """Vectorised membership test: which of `members` are shielded."""
    if exclude is None:
        return np.zeros(len(members), dtype=bool)
    if isinstance(exclude, np.ndarray):
        return exclude[members]
    if isinstance(exclude, tuple):
        m = _excluded_mask(exclude[0], members)
        for e in exclude[1:]:
            m |= _excluded_mask(e, members)
        return m
    return np.fromiter(
        (v in exclude for v in members.tolist()), dtype=bool, count=len(members)
    )


# --------------------------------------------------------------------------
# Interface
# --------------------------------------------------------------------------


class EvictionPolicy:
    """Tracks the set of HOT vertices and picks eviction victims.

    Scalar methods are the original interface; the ``*_many`` batch
    methods default to scalar loops so existing policies keep working,
    while array policies override them with vectorised versions.
    """

    def add(self, vertex: int, pending: int) -> None:
        raise NotImplementedError

    def remove(self, vertex: int) -> None:
        raise NotImplementedError

    def update(self, vertex: int, old_pending: int, new_pending: int) -> None:
        """Called when messages arrive for a HOT vertex."""
        raise NotImplementedError

    def select_victims(self, k: int, exclude=None):
        """Return up to k victims; `exclude` is a set, bool mask, or tuple."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # ------------------------------------------------------------ batch
    def add_many(self, vertices: np.ndarray, pendings: np.ndarray) -> None:
        for v, p in zip(vertices.tolist(), pendings.tolist()):
            self.add(int(v), int(p))

    def remove_many(self, vertices: np.ndarray) -> None:
        for v in vertices.tolist():
            self.remove(int(v))

    def update_many(
        self, vertices: np.ndarray, old_pending: np.ndarray, new_pending: np.ndarray
    ) -> None:
        for v, o, nw in zip(
            vertices.tolist(), old_pending.tolist(), new_pending.tolist()
        ):
            self.update(int(v), int(o), int(nw))


# --------------------------------------------------------------------------
# Scalar (python) implementations — the correctness oracle
# --------------------------------------------------------------------------


class MinPendingPolicy(EvictionPolicy):
    """ATLAS bucket min-heap keyed by pending-message count."""

    def __init__(self):
        self._buckets: dict[int, OrderedDict[int, None]] = {}
        self._score: dict[int, int] = {}
        self._min_score = 0

    def add(self, vertex: int, pending: int) -> None:
        was_empty = not self._score
        self._buckets.setdefault(pending, OrderedDict())[vertex] = None
        self._score[vertex] = pending
        self._min_score = pending if was_empty else min(self._min_score, pending)

    def remove(self, vertex: int) -> None:
        s = self._score.pop(vertex)
        b = self._buckets[s]
        del b[vertex]
        if not b:
            del self._buckets[s]

    def update(self, vertex: int, old_pending: int, new_pending: int) -> None:
        # O(1) bucket move; scores only ever decrease as messages arrive.
        b = self._buckets[old_pending]
        del b[vertex]
        if not b:
            del self._buckets[old_pending]
        self._buckets.setdefault(new_pending, OrderedDict())[vertex] = None
        self._score[vertex] = new_pending
        if new_pending < self._min_score:
            self._min_score = new_pending

    def select_victims(self, k: int, exclude=None) -> list[int]:
        """Scan smallest non-empty buckets upward: O(k + #empty-scans)."""
        victims: list[int] = []
        if not self._score:
            return victims
        contains = _scalar_contains(exclude)
        score = self._min_score
        max_score = max(self._buckets) if self._buckets else 0
        while len(victims) < k and score <= max_score:
            bucket = self._buckets.get(score)
            if bucket:
                for v in bucket:
                    if not contains(v):
                        victims.append(v)
                        if len(victims) >= k:
                            break
            score += 1
        # lazily repair the min pointer to the first non-empty bucket
        while self._min_score <= max_score and self._min_score not in self._buckets:
            self._min_score += 1
        return victims

    def __len__(self) -> int:
        return len(self._score)


class LRUPolicy(EvictionPolicy):
    """Least-recently-updated vertex evicted first (Fig 7 baseline).

    Paper's finding: LRU is the *worst* policy here — high-degree vertices
    still awaiting many messages are evicted by recency and thrash.
    """

    def __init__(self):
        self._order: OrderedDict[int, None] = OrderedDict()

    def add(self, vertex: int, pending: int) -> None:
        self._order[vertex] = None
        self._order.move_to_end(vertex)

    def remove(self, vertex: int) -> None:
        del self._order[vertex]

    def update(self, vertex: int, old_pending: int, new_pending: int) -> None:
        self._order.move_to_end(vertex)  # touched = most recently used

    def select_victims(self, k: int, exclude=None) -> list[int]:
        contains = _scalar_contains(exclude)
        victims = []
        for v in self._order:  # oldest first
            if not contains(v):
                victims.append(v)
                if len(victims) >= k:
                    break
        return victims

    def __len__(self) -> int:
        return len(self._order)


class RandomPolicy(EvictionPolicy):
    """Uniform random victims (Fig 7 baseline). Seeded for determinism."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._vertices: dict[int, int] = {}  # vertex -> index in _list
        self._list: list[int] = []

    def add(self, vertex: int, pending: int) -> None:
        self._vertices[vertex] = len(self._list)
        self._list.append(vertex)

    def remove(self, vertex: int) -> None:
        idx = self._vertices.pop(vertex)
        last = self._list.pop()
        if last != vertex:
            self._list[idx] = last
            self._vertices[last] = idx

    def update(self, vertex: int, old_pending: int, new_pending: int) -> None:
        pass

    def select_victims(self, k: int, exclude=None) -> list[int]:
        contains = _scalar_contains(exclude)
        pool = [v for v in self._list if not contains(v)]
        if len(pool) <= k:
            return pool
        idx = self._rng.choice(len(pool), size=k, replace=False)
        return [pool[i] for i in idx]

    def __len__(self) -> int:
        return len(self._list)


# --------------------------------------------------------------------------
# Array-native implementations — the delivery hot path
# --------------------------------------------------------------------------


class ArrayBucketList:
    """NumPy intrusive doubly-linked bucket lists over an integer key space.

    Key k is a list node: ``nxt[k]``/``prv[k]`` link it within the bucket
    for its integer ``score[k]`` (NIL = not tracked).  New and updated keys
    append at the bucket tail; ``walk_min`` visits buckets from the
    smallest score and each bucket head-first — exactly the FIFO order of
    an ``OrderedDict`` per bucket.

    This is the shared machinery behind the eviction policies (keys =
    vertex ids, score = pending count; a single bucket degenerates to LRU)
    and the serving-side block page cache (keys = global block ids,
    single-bucket LRU) — see repro_torch.serve_gnn.page_cache.
    """

    def __init__(self, capacity: int, max_score: int | None = None):
        v = int(capacity)
        self._nxt = np.full(v, NIL, dtype=np.int64)
        self._prv = np.full(v, NIL, dtype=np.int64)
        self._score = np.full(v, NIL, dtype=np.int64)
        self._pos = np.full(v, NIL, dtype=np.int64)  # batch-detach scratch
        # append timestamp: within a bucket, list order == ascending seq
        # (every insertion is a tail append), which lets batch detach match
        # run starts to run ends with one lexsort instead of pointer chasing
        self._seq = np.zeros(v, dtype=np.int64)
        self._seq_counter = 0
        cap = int(max_score) + 1 if max_score is not None else 64
        cap = max(cap, 1)
        self._head = np.full(cap, NIL, dtype=np.int64)
        self._tail = np.full(cap, NIL, dtype=np.int64)
        self._count = np.zeros(cap, dtype=np.int64)
        self._size = 0
        self._min_lb = 0  # lower bound on the smallest live score

    # --------------------------------------------------------- capacity
    def _ensure_score_capacity(self, smax: int) -> None:
        cap = len(self._head)
        if smax < cap:
            return
        new = max(cap * 2, smax + 1)
        pad = new - cap
        self._head = np.concatenate([self._head, np.full(pad, NIL, np.int64)])
        self._tail = np.concatenate([self._tail, np.full(pad, NIL, np.int64)])
        self._count = np.concatenate([self._count, np.zeros(pad, np.int64)])

    # ------------------------------------------------------------ splice
    def append(self, vs: np.ndarray, scores: np.ndarray) -> None:
        """Append each key at the tail of its score's bucket, preserving
        batch order within equal scores (== sequential oracle order)."""
        self._ensure_score_capacity(int(scores.max()))
        order = np.argsort(scores, kind="stable")
        sv = vs[order]
        sc = scores[order]
        nxt, prv = self._nxt, self._prv
        nxt[sv] = NIL
        same = sc[1:] == sc[:-1]  # chain up each equal-score group
        nxt[sv[:-1][same]] = sv[1:][same]
        prv[sv[1:][same]] = sv[:-1][same]
        first = np.flatnonzero(np.r_[True, ~same])
        last = np.r_[first[1:] - 1, len(sv) - 1]
        heads, tails, buckets = sv[first], sv[last], sc[first]
        old_tail = self._tail[buckets]
        empty = old_tail < 0
        self._head[buckets[empty]] = heads[empty]
        nxt[old_tail[~empty]] = heads[~empty]
        prv[heads] = old_tail
        self._tail[buckets] = tails
        self._count[buckets] += last - first + 1
        self._score[vs] = scores
        self._seq[sv] = self._seq_counter + np.arange(len(sv), dtype=np.int64)
        self._seq_counter += len(sv)
        lo = int(sc[0])
        self._min_lb = lo if self._size == 0 else min(self._min_lb, lo)
        self._size += len(vs)

    def detach(self, vs: np.ndarray) -> None:
        """Unlink a batch (possibly containing adjacent nodes) from its
        buckets in O(batch log batch) with no pointer chasing.

        The batch decomposes into maximal runs of list-adjacent nodes.  A
        run start is a node whose predecessor is outside the batch, a run
        end one whose successor is; within a bucket, list order equals
        ascending ``seq`` order, so sorting starts and ends by
        (bucket, seq) pairs the i-th start with the i-th end, and each
        run's outside neighbours are spliced together in one pass."""
        nxt, prv, score, pos = self._nxt, self._prv, self._score, self._pos
        pos[vs] = np.arange(len(vs), dtype=np.int64)
        pred = prv[vs]
        succ = nxt[vs]
        pred_in = pred >= 0
        pred_in[pred_in] = pos[pred[pred_in]] >= 0
        succ_in = succ >= 0
        succ_in[succ_in] = pos[succ[succ_in]] >= 0
        starts = vs[~pred_in]
        ends = vs[~succ_in]
        # order runs by (bucket, seq); seq is globally unique so a single
        # argsort on the combined key replaces a two-key lexsort
        seq = self._seq
        starts = starts[np.argsort(score[starts] * self._seq_counter + seq[starts])]
        ends = ends[np.argsort(score[ends] * self._seq_counter + seq[ends])]
        left = prv[starts]  # outside predecessor (or NIL)
        right = nxt[ends]  # outside successor (or NIL)
        bucket = score[starts]
        headless = left < 0
        self._head[bucket[headless]] = right[headless]
        nxt[left[~headless]] = right[~headless]
        tailless = right < 0
        self._tail[bucket[tailless]] = left[tailless]
        prv[right[~tailless]] = left[~tailless]
        removed = np.bincount(score[vs])  # length = max batch score + 1
        self._count[: len(removed)] -= removed
        pos[vs] = NIL
        score[vs] = NIL  # detached keys are untracked until re-appended
        self._size -= len(vs)

    # -------------------------------------------------------- membership
    def tracked(self, vs: np.ndarray) -> np.ndarray:
        """Boolean mask: which of `vs` are currently linked."""
        return self._score[vs] >= 0

    # --------------------------------------------------------- traversal
    def walk_min(self, k: int, exclude=None) -> np.ndarray:
        """Up to k keys in (score asc, FIFO-within-bucket) order, skipping
        excluded ones.  Non-destructive: pair with ``detach`` to evict."""
        if self._size == 0:
            return np.empty(0, dtype=np.int64)
        base = self._min_lb
        live_scores = base + np.flatnonzero(self._count[base:])
        if len(live_scores):  # repair the lower bound while we have it
            self._min_lb = int(live_scores[0])
        picked: list[np.ndarray] = []
        need = k
        item = self._nxt.item  # scalar reads ~2x faster than fancy indexing
        for score in live_scores:
            # walk the bucket head-first in blocks sized to the remaining
            # need, filtering the shield vectorised per block, so a large
            # bucket is never fully materialised for a small deficit
            remaining = int(self._count[score])
            v = self._head.item(int(score))
            while remaining and need > 0:
                block = min(remaining, max(2 * need, 64))
                buf = []
                append = buf.append
                for _ in range(block):
                    append(v)
                    v = item(v)
                remaining -= block
                members = np.array(buf, dtype=np.int64)
                keep = members[~_excluded_mask(exclude, members)]
                if len(keep):
                    picked.append(keep[:need])
                    need -= len(picked[-1])
            if need <= 0:
                break
        if not picked:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(picked)

    def __len__(self) -> int:
        return self._size


class ArrayMinPendingPolicy(EvictionPolicy):
    """Min-pending buckets over the shared ``ArrayBucketList``: keys are
    vertex ids, scores are pending counts.  Victim selection walks buckets
    smallest-score-first, head-first — exactly the FIFO order of the
    ``OrderedDict`` oracle, so victim sets match bit-for-bit."""

    def __init__(self, num_vertices: int, max_pending: int | None = None):
        self._list = ArrayBucketList(num_vertices, max_score=max_pending)

    # ------------------------------------------------------------- batch
    def _scores_for(self, vs: np.ndarray, pendings: np.ndarray) -> np.ndarray:
        return np.asarray(pendings, dtype=np.int64)

    def add_many(self, vertices: np.ndarray, pendings: np.ndarray) -> None:
        vs = np.asarray(vertices, dtype=np.int64)
        if not len(vs):
            return
        self._list.append(vs, self._scores_for(vs, pendings))

    def remove_many(self, vertices: np.ndarray) -> None:
        vs = np.asarray(vertices, dtype=np.int64)
        if not len(vs):
            return
        tracked = self._list.tracked(vs)
        if not np.all(tracked):
            raise KeyError(f"vertex {int(vs[~tracked][0])} not tracked by policy")
        self._list.detach(vs)

    def update_many(
        self, vertices: np.ndarray, old_pending: np.ndarray, new_pending: np.ndarray
    ) -> None:
        vs = np.asarray(vertices, dtype=np.int64)
        if not len(vs):
            return
        scores = self._scores_for(vs, new_pending)
        self._list.detach(vs)
        self._list.append(vs, scores)

    # ------------------------------------------------------------ scalar
    def add(self, vertex: int, pending: int) -> None:
        self.add_many(np.array([vertex]), np.array([pending]))

    def remove(self, vertex: int) -> None:
        self.remove_many(np.array([vertex]))

    def update(self, vertex: int, old_pending: int, new_pending: int) -> None:
        self.update_many(
            np.array([vertex]), np.array([old_pending]), np.array([new_pending])
        )

    # --------------------------------------------------------- selection
    def select_victims(self, k: int, exclude=None) -> np.ndarray:
        return self._list.walk_min(k, exclude=exclude)

    def __len__(self) -> int:
        return len(self._list)


class ArrayLRUPolicy(ArrayMinPendingPolicy):
    """LRU as a single bucket of the intrusive list: append = touch,
    selection walks head-first = oldest-first."""

    def __init__(self, num_vertices: int):
        super().__init__(num_vertices, max_pending=0)

    def _scores_for(self, vs: np.ndarray, pendings: np.ndarray) -> np.ndarray:
        return np.zeros(len(vs), dtype=np.int64)


class ArrayRandomPolicy(EvictionPolicy):
    """Random ablation over a dense member array.

    Removal replays the oracle's sequential swap-remove so the member
    order — and therefore the rng-driven victim choice — matches the
    scalar ``RandomPolicy`` exactly for the same seed.
    """

    def __init__(self, num_vertices: int, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._members = np.empty(int(num_vertices), dtype=np.int64)
        self._pos = np.full(int(num_vertices), NIL, dtype=np.int64)
        self._n = 0

    def add_many(self, vertices: np.ndarray, pendings: np.ndarray) -> None:
        vs = np.asarray(vertices, dtype=np.int64)
        n = len(vs)
        self._members[self._n : self._n + n] = vs
        self._pos[vs] = np.arange(self._n, self._n + n, dtype=np.int64)
        self._n += n

    def remove_many(self, vertices: np.ndarray) -> None:
        members, pos = self._members, self._pos
        for v in np.asarray(vertices, dtype=np.int64).tolist():
            i = pos[v]
            if i < 0:
                raise KeyError(f"vertex {v} not tracked by policy")
            pos[v] = NIL
            self._n -= 1
            last = members[self._n]
            if last != v:
                members[i] = last
                pos[last] = i

    def update_many(self, vertices, old_pending, new_pending) -> None:
        pass

    def add(self, vertex: int, pending: int) -> None:
        self.add_many(np.array([vertex]), np.array([pending]))

    def remove(self, vertex: int) -> None:
        self.remove_many(np.array([vertex]))

    def update(self, vertex: int, old_pending: int, new_pending: int) -> None:
        pass

    def select_victims(self, k: int, exclude=None) -> np.ndarray:
        pool = self._members[: self._n]
        pool = pool[~_excluded_mask(exclude, pool)]
        if len(pool) <= k:
            return pool.copy()
        idx = self._rng.choice(len(pool), size=k, replace=False)
        return pool[idx]

    def __len__(self) -> int:
        return self._n


# --------------------------------------------------------------------------
# Factory
# --------------------------------------------------------------------------


def make_policy(
    name: str,
    seed: int = 0,
    impl: str = "python",
    num_vertices: int | None = None,
    max_pending: int | None = None,
) -> EvictionPolicy:
    name = name.lower()
    impl = impl.lower()
    if name in ("at", "min_pending", "minpending", "atlas"):
        if impl == "python":
            return MinPendingPolicy()
        if impl == "array":
            _require_num_vertices(num_vertices)
            return ArrayMinPendingPolicy(num_vertices, max_pending=max_pending)
    elif name == "lru":
        if impl == "python":
            return LRUPolicy()
        if impl == "array":
            _require_num_vertices(num_vertices)
            return ArrayLRUPolicy(num_vertices)
    elif name in ("rnd", "random"):
        if impl == "python":
            return RandomPolicy(seed)
        if impl == "array":
            _require_num_vertices(num_vertices)
            return ArrayRandomPolicy(num_vertices, seed=seed)
    else:
        raise ValueError(f"unknown eviction policy {name!r}")
    raise ValueError(f"unknown policy impl {impl!r} (expected 'array' or 'python')")


def _require_num_vertices(num_vertices: int | None) -> None:
    if num_vertices is None:
        raise ValueError("array policies need num_vertices at construction")
