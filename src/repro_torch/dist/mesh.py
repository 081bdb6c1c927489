"""Device-mesh building blocks for distributed ATLAS: the broadcast
execution model as a push-style SpMM over a (data, model) /
(pod, data, model) mesh of torch devices.

The paper's single-machine insight — *stream every source feature exactly
once and push messages along out-edges, instead of destinations pulling
with random repeated reads* — maps onto a distributed push-SpMM:

  * vertices are range-partitioned over the data-parallel axes (every
    axis but ``model``, flattened in row-major order);
  * the feature dim shards over ``model``: messages stay D-sharded end to
    end, so the all_to_all moves 1/|model| of every message;
  * each position reads ITS source shard once and builds messages in the
    bucket order the destination shard expects; one all_to_all over the
    data axes routes them (the paper's "broadcast along out-edges");
  * destinations sum into their local accumulator, then graduate through
    the dense transform: a row-parallel product over ``model`` with a
    reduce-scatter epilogue, leaving the output sharded for the next
    layer.

Static shapes: edges are pre-bucketed by (src_shard, dst_shard) and
padded to the largest bucket; padding edges point at the dump row
``v_local`` with weight 0.

Port notes.  The plans are the JAX package's host numpy, field for field
and bit for bit; each also carries the orders kernel K1 reads, computed
once here by a stable sort, so that within a segment the edges keep the
reference's (src, dst) order and no sort runs per layer.  A ``Mesh`` is a
shape, axis names and one device name per position, which may repeat:
``["cuda:0"] * 8`` lays a (4, 2) mesh on one card and ``["cpu"] * 8`` on
the host, the port's form of the reference's placeholder devices.  Per
layer and position (i, m) of a step:

  1. source side, on K1 (``segment_reduce_sorted``): the combined step
     sums each bucket's edges into one partial per distinct destination
     (segments ``j·U + slot``); the baseline step forms one message per
     edge (one edge a segment).  K1 drops the padding edges' source
     ``v_local``, so dump rows come out zero.  The slab is cast to the
     feature dtype: the wire carries it;
  2. the tiled all_to_all over the data axes, ``recv[t][i] =
     send[i][t]``, as device copies for each model shard;
  3. destination side, on K1 with weight 1: the received rows summed by
     destination in sender order, dump slots left out (``chunks > 1``:
     ``acc + chunk`` in chunk order from a zero f32 accumulator);
  4. graduation on K2 (``activation="none"``, zero bias; with ``has_self``
     on ``[feats | agg]`` against ``[w_self ; w_agg]``), then the
     reduce-scatter over ``model``: the f32 partials summed in model-shard
     order, each position keeping its columns; then bias, relu and the
     cast.  With one model shard, bias and relu fuse into the K2 call.

No float atomics anywhere: every sum has one fixed order, so on exact
graphs (``repro_torch.exact``) every mesh gives the dense reference's
bits.

GAT (port-only, ``GATLayerStep``, ``make_combined_layer_step(...,
kind="gat")``) transforms before it aggregates, and splits its heads over
``model`` (each layer's heads must divide by M).  Per layer and position:

  1. project: K2's row-parallel product ``x @ [W | W_skip]`` (model shard
     m's columns of every head group side by side), reduce-scattered so
     that each position keeps its heads' columns;
  2. score: ``s``, ``t`` of its heads (``kernels/segment_attention.py``);
     each destination shard gathers ``t`` at its slots for each source
     shard and sends them there (the plan's ``slot_dst``);
  3. aggregate: per combine segment and head the partial ``(num, den,
     mx)`` of the softmax over the segment's edges, its own max
     subtracted;
  4. exchange: the partials through the tiled all_to_all;
  5. normalize: each destination's partials rescaled to their largest max
     and summed in sender order, ``num / den``, bias, skip, then ELU
     (hidden layers) or the mean over heads, summed over the model shards
     in order (the output layer).

So the softmax is exact over every in-edge of a destination, whichever
bucket, slab or source shard they sit in, and the partials need no
second trip.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, degrees_from_csr
from repro_torch.kernels.edge_block_spmm import segment_reduce_sorted
from repro_torch.kernels.fused_graduate import fused_graduate
from repro_torch.kernels.segment_attention import (
    attention_normalize,
    attention_scores,
    attention_slabs,
    segment_attention,
)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.perf import hlo_cost

GAT_NEGATIVE_SLOPE = 0.2  # the LeakyReLU of GAT's logits (Veličković et al., §2.1)


def _stable_segments(keys: np.ndarray, num_segments: int) -> tuple[np.ndarray, np.ndarray]:
    """``(order, offsets)``: ``keys`` stably sorted, and segment ``k``'s
    entries at ``order[offsets[k]:offsets[k+1]]``; keys of
    ``num_segments`` or more (the dump) sort past ``offsets[-1]``."""
    order = np.argsort(keys, kind="stable")
    offsets = np.searchsorted(keys[order], np.arange(num_segments + 1))
    return order.astype(np.int32), offsets.astype(np.int32)


def _stacked_segments(keys: np.ndarray, num_segments: int) -> tuple[np.ndarray, np.ndarray]:
    """``_stable_segments`` of each row of ``keys`` ``[S, ...]``."""
    pairs = [_stable_segments(k.reshape(-1), num_segments) for k in keys]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@dataclasses.dataclass
class EdgePlan:
    """Per-device, per-peer edge buckets (host-side prep, one pass)."""

    num_shards: int
    v_local: int  # padded vertices per shard
    bucket: int  # padded edges per (src_shard, dst_shard) bucket
    # on the SOURCE shard: local source row + weight for each outgoing msg
    src_local: np.ndarray  # [S, S, Eb]  (owner shard, dst shard, edge)
    weight: np.ndarray  # [S, S, Eb] float32
    # on the DEST shard: local dst row for each incoming msg, same order
    dst_local: np.ndarray  # [S, S, Eb]  (owner shard, src shard, edge)
    # port-only, K1's destination side: shard t's received rows (flat
    # over [S, Eb], sender-major) stably sorted by dst_local[t], dump last;
    # destination k's rows are recv_order[t, recv_offsets[t, k]:...[t, k+1]]
    recv_order: np.ndarray  # [S, S·Eb] int32
    recv_offsets: np.ndarray  # [S, v_local + 1] int32


def build_edge_plan(csr: CSRGraph, num_shards: int, kind: str = "gcn") -> EdgePlan:
    """Range-partition vertices; bucket edges by (src_shard, dst_shard).

    Message order within a bucket is (src, dst)-sorted — both sides derive
    it independently, so only message *values* ever travel."""
    v = csr.num_vertices
    v_local = -(-v // num_shards)
    in_deg, _ = degrees_from_csr(csr)
    src, dst = csr.edges_for_range(0, v)
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    if kind == "gcn":
        d = np.maximum(in_deg, 1).astype(np.float64)
        w = (1.0 / np.sqrt(d[src] * d[dst])).astype(np.float32)
    elif kind == "sage":
        d = np.maximum(in_deg, 1).astype(np.float64)
        w = (1.0 / d[dst]).astype(np.float32)
    else:  # gin, and gat (whose attention the step computes from the features)
        w = np.ones(len(src), np.float32)

    ssh, dsh = src // v_local, dst // v_local
    order = np.lexsort((dst, src, dsh, ssh))
    src, dst, w, ssh, dsh = src[order], dst[order], w[order], ssh[order], dsh[order]
    pair = ssh * num_shards + dsh
    counts = np.bincount(pair, minlength=num_shards * num_shards)
    bucket = max(1, int(counts.max()))

    s = num_shards
    src_local = np.full((s, s, bucket), v_local, np.int32)  # dump row
    weight = np.zeros((s, s, bucket), np.float32)
    dst_local = np.full((s, s, bucket), v_local, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for i in range(s):
        for j in range(s):
            lo, hi = starts[i * s + j], starts[i * s + j + 1]
            n = hi - lo
            src_local[i, j, :n] = src[lo:hi] - i * v_local
            weight[i, j, :n] = w[lo:hi]
            dst_local[j, i, :n] = dst[lo:hi] - j * v_local
    recv_order, recv_offsets = _stacked_segments(dst_local, v_local)
    return EdgePlan(num_shards=s, v_local=v_local, bucket=bucket,
                    src_local=src_local, weight=weight, dst_local=dst_local,
                    recv_order=recv_order, recv_offsets=recv_offsets)


def pad_features(feats: np.ndarray, plan: EdgePlan) -> np.ndarray:
    v, d = feats.shape
    vp = plan.num_shards * plan.v_local
    out = np.zeros((vp, d), feats.dtype)
    out[:v] = feats
    return out


def pad_graph(csr: CSRGraph, plan: EdgePlan) -> CSRGraph:
    """``csr`` with isolated vertices up to ``S·v_local``: the padded rows
    the mesh carries.  They have no edges, so a dense reference on this
    graph and ``pad_features`` computes every row the steps return
    (``act(bias)`` at the first layer)."""
    pad = plan.num_shards * plan.v_local - csr.num_vertices
    return CSRGraph(indptr=np.concatenate([csr.indptr, np.full(pad, csr.indptr[-1])]),
                    indices=csr.indices)


@dataclasses.dataclass
class CombinedEdgePlan:
    """Edge plan with source-side combining.

    The paper's chunk aggregation pre-sums messages *by destination*
    before they touch the hot store; distributed, the same combine runs
    BEFORE the all_to_all: each (src_shard, dst_shard) bucket ships one
    partial per *distinct* destination instead of one message per edge —
    wire volume drops from E to U = sum of per-bucket distinct
    destinations (the heavy-tailed fan-in is exactly where it wins).
    """

    num_shards: int
    v_local: int
    bucket: int  # padded edges per bucket (compute side)
    slots: int  # padded distinct destinations per bucket (wire side)
    src_local: np.ndarray  # [S, S, Eb] on the source shard
    weight: np.ndarray  # [S, S, Eb]
    edge_slot: np.ndarray  # [S, S, Eb] edge -> combine slot (source shard)
    slot_dst: np.ndarray  # [S, S, U] slot -> dst_local (dest shard)
    reuse: float  # E / U  (combining win on this graph)
    # port-only, K1's source side: shard i's edges (flat over [S, Eb])
    # stably sorted by segment j·U + edge_slot[i, j]
    combine_order: np.ndarray  # [S, S·Eb] int32
    combine_offsets: np.ndarray  # [S, S·U + 1] int32
    # port-only, K1's destination side: shard t's received slot rows (flat
    # over [S, U], sender-major) stably sorted by slot_dst[t], dump last
    recv_order: np.ndarray  # [S, S·U] int32
    recv_offsets: np.ndarray  # [S, v_local + 1] int32


def build_combined_plan(
    csr: CSRGraph, num_shards: int, kind: str = "gcn"
) -> CombinedEdgePlan:
    base = build_edge_plan(csr, num_shards, kind)
    s, eb, vl = base.num_shards, base.bucket, base.v_local
    edge_slot = np.zeros((s, s, eb), np.int32)
    slot_lists = []
    u_max = 1
    total_edges = 0
    total_slots = 0
    for i in range(s):
        for j in range(s):
            dst = base.dst_local[j, i]  # receiver order == sender order
            valid = dst < vl
            uniq, inv = np.unique(dst[valid], return_inverse=True)
            sl = np.zeros(eb, np.int32)
            sl[valid] = inv
            sl[~valid] = len(uniq)  # dump slot for padding edges
            edge_slot[i, j] = sl
            slot_lists.append((i, j, uniq))
            u_max = max(u_max, len(uniq) + 1)
            total_edges += int(valid.sum())
            total_slots += len(uniq)
    slot_dst = np.full((s, s, u_max), vl, np.int32)
    for i, j, uniq in slot_lists:
        slot_dst[j, i, : len(uniq)] = uniq  # stored on the DEST shard
    segment = np.arange(s, dtype=np.int64)[:, None] * u_max + edge_slot
    combine_order, combine_offsets = _stacked_segments(segment, s * u_max)
    recv_order, recv_offsets = _stacked_segments(slot_dst, vl)
    return CombinedEdgePlan(
        num_shards=s, v_local=vl, bucket=eb, slots=u_max,
        src_local=base.src_local, weight=base.weight,
        edge_slot=edge_slot, slot_dst=slot_dst,
        reuse=total_edges / max(total_slots, 1),
        combine_order=combine_order, combine_offsets=combine_offsets,
        recv_order=recv_order, recv_offsets=recv_offsets,
    )


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: ``shape``, ``axis_names`` and one device name per
    position in row-major order (names may repeat); ``devices=None``
    stands for ``cuda:0 .. cuda:n-1``.  Holds names only: building one
    touches no device (``torch_devices`` resolves them)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices: tuple[str, ...] | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in rank")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes repeat: {self.axis_names}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(
                f"a mesh of shape {self.shape} needs {self.size} device names, "
                f"got {len(self.devices)}"
            )

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """The data-parallel axes: every axis but ``"model"``."""
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def num_shards(self) -> int:
        """S: positions along the data-parallel axes, flattened."""
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in self.dp_axes)

    @property
    def model_size(self) -> int:
        """M: positions along ``"model"`` (1 without that axis)."""
        return dict(zip(self.axis_names, self.shape)).get("model", 1)

    def positions(self) -> np.ndarray:
        """``[S, M]`` row-major position of (data shard i, model shard m)."""
        grid = np.arange(self.size).reshape(self.shape)
        if "model" in self.axis_names:
            grid = np.moveaxis(grid, self.axis_names.index("model"), -1)
        return grid.reshape(self.num_shards, self.model_size)

    def torch_devices(self) -> list[list[torch.device]]:
        """``[S][M]`` torch devices, each name through ``resolve_device``
        (which raises for CUDA without a card; ``devices=None`` raises when
        there are fewer cards than positions)."""
        names = self.devices
        if names is None:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if have < self.size:
                raise RuntimeError(
                    f"a mesh of {self.size} positions needs >= {self.size} CUDA "
                    f"devices, have {have} (pass mesh devices explicitly, e.g. "
                    f"{['cuda:0'] * self.size!r} on one GPU or "
                    f"{['cpu'] * self.size!r} on the CPU)"
                )
            names = tuple(f"cuda:{k}" for k in range(self.size))
        resolved = {}
        for name in set(names):
            dev = resolve_device(name)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            resolved[name] = dev
        return [[resolved[names[p]] for p in row] for row in self.positions()]


def _per_shard(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} does not divide by {parts} mesh shards")
    return n // parts


def shard_features(mesh: Mesh, feats) -> list[list[torch.Tensor]]:
    """Padded ``[S·v_local, D]`` features (``pad_features``) as the steps'
    ``[i][m]`` shards: rows split over the data axes, columns over
    ``model``, each a contiguous tensor on its position's device."""
    x = torch.as_tensor(feats)
    grid = mesh.torch_devices()
    s, m = mesh.num_shards, mesh.model_size
    vl = _per_shard(x.shape[0], s, "padded rows")
    dl = _per_shard(x.shape[1], m, "width")
    return [[x[i * vl:(i + 1) * vl, j * dl:(j + 1) * dl].to(grid[i][j]).contiguous()
             for j in range(m)] for i in range(s)]


def gather_shards(shards: list[list[torch.Tensor]]) -> torch.Tensor:
    """The ``[i][m]`` shards back as one ``[S·v_local, F]`` CPU tensor."""
    return torch.cat([torch.cat([t.cpu() for t in row], dim=1) for row in shards])


@dataclasses.dataclass(frozen=True)
class WireBytes:
    """Bytes one layer moves between distinct mesh positions (positions
    that share a device count too)."""

    all_to_all: int
    reduce_scatter: int

    @property
    def total(self) -> int:
        return self.all_to_all + self.reduce_scatter


def wire_bytes(num_shards: int, model_size: int, rows: int, d: int, itemsize: int,
               v_local: int, f: int) -> WireBytes:
    """The formula: the all_to_all's ``S·(S−1)`` slabs of ``rows`` (the
    bucket Eb, or the slots U) × D values of ``itemsize`` bytes, summed over
    the model shards, and the reduce-scatter's ``M−1`` f32 column blocks
    ``[v_local, F/M]`` into each of the ``S·M`` positions."""
    s, m = num_shards, model_size
    return WireBytes(all_to_all=s * (s - 1) * rows * d * itemsize,
                     reduce_scatter=s * (m - 1) * v_local * f * 4)


class LayerStep:
    """One broadcast GNN layer on a mesh (``make_layer_step``,
    ``make_combined_layer_step``).

    ``step(feats, plan, w_agg[, w_self], bias) -> next feats``:

      feats   ``[S][M]`` tensors ``[v_local, D/M]`` on each position's device
      plan    ``CombinedEdgePlan`` (combined step) or ``EdgePlan``
      w_agg   ``[D, F]`` (row-parallel: model shard m takes its D/M rows)
      w_self  ``[D, F]`` (``has_self``: the SAGE self term)
      bias    ``[F]`` (model shard m adds its F/M columns)
      returns ``[S][M]`` tensors ``[v_local, F/M]`` in feats' dtype

    Weights share feats' dtype (float32 or bfloat16).  ``wire_bytes``
    holds the last call's ``WireBytes``, counted as the copies run.
    """

    def __init__(self, mesh: Mesh, *, combine: bool, has_self: bool,
                 activation: bool, chunks: int):
        if "model" not in mesh.axis_names:
            raise ValueError(f"the layer steps need a 'model' axis, mesh has {mesh.axis_names}")
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        self.devices = mesh.torch_devices()
        self.s, self.m = mesh.num_shards, mesh.model_size
        self.combine, self.has_self, self.activation = combine, has_self, activation
        self.chunks = 1 if combine else chunks
        self.wire_bytes: WireBytes | None = None
        self._moved = 0
        self._plan = None
        self._index: dict = {}

    # ------------------------------------------------------------- plans
    def _use_plan(self, plan) -> None:
        want = CombinedEdgePlan if self.combine else EdgePlan
        if not isinstance(plan, want):
            raise TypeError(f"this step takes a {want.__name__}, got {type(plan).__name__}")
        if plan.num_shards != self.s:
            raise ValueError(f"plan has {plan.num_shards} shards, the mesh's data axes {self.s}")
        if plan is not self._plan:
            self._plan, self._index = plan, {}

    def _rows(self) -> int:
        """Rows per bucket on the wire, per chunk."""
        plan = self._plan
        return plan.slots if self.combine else -(-plan.bucket // self.chunks)

    def _host_source(self, i: int, c: int):
        """``(src, w, offsets)`` of shard i's source-side K1 call, chunk c."""
        plan, s = self._plan, self.s
        if self.combine:
            order = plan.combine_order[i]
            return (plan.src_local[i].reshape(-1)[order], plan.weight[i].reshape(-1)[order],
                    plan.combine_offsets[i])
        cb = self._rows()
        pad = self.chunks * cb - plan.bucket
        src = np.pad(plan.src_local[i], ((0, 0), (0, pad)), constant_values=plan.v_local)
        w = np.pad(plan.weight[i], ((0, 0), (0, pad)))
        cut = slice(c * cb, (c + 1) * cb)
        return (src[:, cut].reshape(-1), w[:, cut].reshape(-1),
                np.arange(s * cb + 1, dtype=np.int32))  # one edge a segment

    def _host_dest(self, t: int, c: int):
        """``(rows, w, offsets)`` of shard t's destination-side K1 call,
        chunk c: the received rows by destination, dump left out."""
        plan = self._plan
        order = plan.recv_order[t, :plan.recv_offsets[t, -1]]
        if self.combine:
            return order, np.ones(len(order), np.float32), plan.recv_offsets[t]
        eb, cb = plan.bucket, self._rows()
        sender, e = np.divmod(order, eb)
        keep = e // cb == c  # a subsequence of a stable order stays stable
        rows = (sender[keep] * cb + e[keep] - c * cb).astype(np.int32)
        dst = plan.dst_local[t].reshape(-1)[order[keep]]
        offsets = np.searchsorted(dst, np.arange(plan.v_local + 1)).astype(np.int32)
        return rows, np.ones(len(rows), np.float32), offsets

    def _placed(self, side: str, shard: int, c: int, device: torch.device):
        key = (side, shard, c, device)
        if key not in self._index:
            host = (self._host_source if side == "source" else self._host_dest)(shard, c)
            self._index[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)
        return self._index[key]

    # ------------------------------------------------------------- layer
    def __call__(self, feats, plan, w_agg, *rest):
        if len(rest) != (2 if self.has_self else 1):
            raise TypeError("step(feats, plan, w_agg, w_self, bias) with has_self, "
                            "else step(feats, plan, w_agg, bias)")
        w_self, bias = rest if self.has_self else (None, rest[0])
        self._use_plan(plan)
        dtype = self._check_feats(feats)
        self._moved = 0
        agg = self._aggregate(feats)
        moved, self._moved = self._moved, 0
        out = self._graduate(feats, agg, w_agg, w_self, bias, dtype)
        self.wire_bytes = WireBytes(moved, self._moved)
        return out

    def _move(self, x: torch.Tensor, frm: tuple[int, int], to: tuple[int, int]) -> torch.Tensor:
        """``x`` from mesh position ``frm`` to ``to`` (``(i, m)`` pairs) on
        ``to``'s device; bytes between distinct positions are counted, and
        noted to an op record: across data shards the all_to_all's, within
        one the reduce-scatter's."""
        if frm != to:
            self._moved += x.nbytes
            hlo_cost.note_copy("all-to-all" if frm[0] != to[0] else "reduce-scatter", x.nbytes)
        return x.to(self.devices[to[0]][to[1]])

    def _check_feats(self, feats) -> torch.dtype:
        s, m, vl = self.s, self.m, self._plan.v_local
        if len(feats) != s or any(len(row) != m for row in feats):
            raise ValueError(f"feats must be [{s}][{m}] shards")
        first = feats[0][0]
        for i, row in enumerate(feats):
            for j, x in enumerate(row):
                if x.dim() != 2 or x.shape != first.shape or x.shape[0] != vl:
                    raise ValueError(f"shard ({i}, {j}) is {tuple(x.shape)}, want "
                                     f"[{vl}, {first.shape[1]}] like every shard")
                if x.dtype != first.dtype or x.device != self.devices[i][j]:
                    raise ValueError(f"shard ({i}, {j}) is {x.dtype} on {x.device}, want "
                                     f"{first.dtype} on {self.devices[i][j]}")
        return first.dtype

    def _aggregate(self, feats):
        """Source side, all_to_all, destination side: ``[S][M]`` f32
        ``[v_local, D/M]`` aggregates."""
        s, m = self.s, self.m
        agg = None
        for c in range(self.chunks):
            send = []
            for i in range(s):
                row = []
                for j in range(m):
                    x = feats[i][j]
                    src, w, offsets = self._placed("source", i, c, x.device)
                    slab = segment_reduce_sorted(x, src, w, offsets).to(x.dtype)
                    row.append(slab.view(s, -1, x.shape[1]))
                send.append(row)
            recv = []  # the tiled all_to_all: recv[t][i] = send[i][t]
            for t in range(s):
                recv.append([torch.stack([self._move(send[i][j][t], (i, j), (t, j))
                                          for i in range(s)]) for j in range(m)])
            del send
            part = [[self._dest_sum(recv[t][j], t, c) for j in range(m)] for t in range(s)]
            if self.chunks == 1:
                agg = part
            else:
                if agg is None:
                    agg = [[torch.zeros_like(p) for p in row] for row in part]
                agg = [[a + p for a, p in zip(ar, pr)] for ar, pr in zip(agg, part)]
        return agg

    def _dest_sum(self, recv: torch.Tensor, t: int, c: int) -> torch.Tensor:
        rows, ones, offsets = self._placed("dest", t, c, recv.device)
        return segment_reduce_sorted(recv.view(-1, recv.shape[-1]), rows, ones, offsets)

    def _graduate(self, feats, agg, w_agg, w_self, bias, dtype):
        """K2 per position, then the reduce-scatter over ``model``:
        ``[S][M]`` outputs ``[v_local, F/M]``."""
        s, m = self.s, self.m
        w_agg, bias = torch.as_tensor(w_agg), torch.as_tensor(bias)
        w_self = torch.as_tensor(w_self) if self.has_self else None
        d, f = m * feats[0][0].shape[1], w_agg.shape[1]
        weights = [w_agg] + ([w_self] if self.has_self else [])
        for w in weights:
            if w.shape != (d, f):
                raise ValueError(f"weights must be [{d}, {f}], got {tuple(w.shape)}")
        if bias.shape != (f,):
            raise ValueError(f"bias must be [{f}], got {tuple(bias.shape)}")
        if any(t.dtype != dtype for t in (*weights, bias)):
            raise TypeError(f"weights and bias must share the features' dtype {dtype}")
        fm = _per_shard(f, m, "output width")
        dl = d // m
        act = "relu" if self.activation else "none"

        placed = {}

        def on(j: int, dev: torch.device):
            """Model shard j's weight rows (``[w_self ; w_agg]``) and bias
            columns on ``dev``, copied once a device."""
            if (j, dev) not in placed:
                rows = slice(j * dl, (j + 1) * dl)
                w = torch.cat([w_self[rows], w_agg[rows]]) if self.has_self else w_agg[rows]
                placed[j, dev] = (w.to(dev).contiguous(),
                                  bias[j * fm:(j + 1) * fm].to(dev).contiguous(),
                                  torch.zeros(f, dtype=dtype, device=dev))
            return placed[j, dev]

        outs = []
        for i in range(s):
            row = []
            for j in range(m):
                x = agg[i][j].to(dtype)
                if self.has_self:
                    x = torch.cat([feats[i][j], x], dim=1)
                w, b, zero = on(j, x.device)
                if m == 1:  # no reduce-scatter: bias and relu fuse into K2
                    row.append(fused_graduate(x, w, b, act))
                else:
                    row.append(fused_graduate(x, w, zero, "none").float())
            outs.append(row)
        if m == 1:
            return outs
        result = []
        for i in range(s):
            row = []
            for j in range(m):
                cols = slice(j * fm, (j + 1) * fm)
                pieces = [self._move(outs[i][k][:, cols], (i, k), (i, j)) for k in range(m)]
                y = functools.reduce(torch.add, pieces)  # f32, model-shard order
                y = y + on(j, y.device)[1].float()
                if self.activation:
                    y = torch.relu(y)
                row.append(y.to(dtype))
            result.append(row)
        return result


class GATLayerStep(LayerStep):
    """One GAT layer on a mesh with a ``CombinedEdgePlan``, its heads split
    over ``model`` (``make_combined_layer_step(mesh, kind="gat", ...)``).

    ``step(feats, plan, w, a_src, a_dst, bias, w_skip=None) -> next feats``:

      feats   ``[S][M]`` float32 ``[v_local, D/M]``
      w       ``[D, H·F]`` (head h's columns ``h·F ..``), ``w_skip`` the same
      a_src, a_dst  ``[H, F]``
      bias    ``[H·F]`` (the output layer: ``b^h`` per head)
      returns ``[S][M]`` float32: ``[v_local, H·F/M]`` with ``concat`` (model
      shard m's heads ``m·H/M ..``, through ELU with ``activation``), else
      ``[v_local, F/M]`` of the mean over heads

    H must divide by M.  With an enabled ``tracer`` each phase is a span of
    category ``gat`` (``project``, ``score``, ``aggregate``, ``exchange``,
    ``normalize``), and on the card CUDA events around score .. normalize
    time the attention: ``attention_seconds()`` sums them (it waits for
    them).  The null tracer records nothing and adds no synchronisation.
    """

    def __init__(self, mesh: Mesh, *, concat: bool = True, activation: bool = True,
                 tracer=NULL_TRACER):
        super().__init__(mesh, combine=True, has_self=False, activation=activation, chunks=1)
        if activation and not concat:
            raise ValueError("the mean over heads is the output layer's: no activation")
        self.concat = concat
        self.tracer = tracer
        self._events: list = []  # (start, end) CUDA events of each traced call

    def attention_seconds(self) -> float:
        """Device seconds between the attention's events (score .. normalize)
        since the last call, summed over the calls traced on the card."""
        total = 0.0
        for start, end in self._events:
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        self._events = []
        return total

    def _gat_placed(self, what: str, i: int, j: int, device: torch.device):
        """Host-built indices on ``device``, once: ``"source"`` shard i's
        sorted sources, segment offsets and slab table; ``"slots"`` the
        destination rows of shard j's slots for source shard i (the dump
        slots at row ``v_local``)."""
        key = ("gat", what, i, j, device)
        if key not in self._index:
            plan = self._plan
            if what == "source":
                src, _, offsets = self._placed("source", i, 0, device)
                self._index[key] = (src, offsets, attention_slabs(offsets.cpu()).to(device))
            else:
                self._index[key] = torch.from_numpy(
                    plan.slot_dst[j, i].astype(np.int64)).to(device)
        return self._index[key]

    def __call__(self, feats, plan, w, a_src, a_dst, bias, w_skip=None):
        self._use_plan(plan)
        if self._check_feats(feats) != torch.float32:
            raise TypeError("the GAT step runs float32 features")
        s, m, tr = self.s, self.m, self.tracer
        w, a_src, a_dst, bias = (torch.as_tensor(t) for t in (w, a_src, a_dst, bias))
        heads, f = a_src.shape
        d = m * feats[0][0].shape[1]
        if heads % m:
            raise ValueError(f"the layer's {heads} heads do not divide by {m} model shards")
        hl = heads // m
        want = {"w": (w, (d, heads * f)), "a_dst": (a_dst, (heads, f)),
                "bias": (bias, (heads * f,))}
        if w_skip is not None:
            w_skip = torch.as_tensor(w_skip)
            want["w_skip"] = (w_skip, (d, heads * f))
        for name, (t, shape) in want.items():
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
        if w_skip is not None and not self.concat:
            raise ValueError("a skip is added to concatenated heads only")
        if any(t.dtype != torch.float32 for t, _ in want.values()) or a_src.dtype != torch.float32:
            raise TypeError("the GAT step's weights must be float32")
        cols = [slice(j * hl * f, (j + 1) * hl * f) for j in range(m)]
        self._moved = 0
        with tr.span("project", "gat"):
            zc = self._project(feats, w, w_skip, cols)
        rs, self._moved = self._moved, 0
        timed = tr.enabled and self.devices[0][0].type == "cuda"
        if timed:
            start = {dev: torch.cuda.Event(enable_timing=True)
                     for dev in {x for row in self.devices for x in row}}
            for dev, ev in start.items():
                ev.record(torch.cuda.current_stream(dev))
        with tr.span("score", "gat"):
            z = [[zc[i][j][:, :hl * f] for j in range(m)] for i in range(s)]
            st = [[attention_scores(z[i][j], a_src[j * hl:(j + 1) * hl].to(z[i][j].device),
                                    a_dst[j * hl:(j + 1) * hl].to(z[i][j].device))
                   for j in range(m)] for i in range(s)]
            t_seg = [[self._dest_scores(st, i, j) for j in range(m)] for i in range(s)]
        with tr.span("aggregate", "gat"):
            parts = []
            for i in range(s):
                row = []
                for j in range(m):
                    src, offsets, slabs = self._gat_placed("source", i, 0, z[i][j].device)
                    row.append(segment_attention(z[i][j], st[i][j][0], t_seg[i][j], src, offsets,
                                                 GAT_NEGATIVE_SLOPE, slabs))
                parts.append(row)
        del t_seg
        with tr.span("exchange", "gat"):
            recv = [[self._exchange(parts, t, j) for j in range(m)] for t in range(s)]
        del parts
        a2a, self._moved = self._moved, 0
        with tr.span("normalize", "gat"):
            out = [[self._normalize(recv[t][j], zc[t][j][:, hl * f:] if w_skip is not None
                                    else None, bias[cols[j]], t, j, heads)
                    for j in range(m)] for t in range(s)]
        del recv, zc
        if timed:
            for dev, ev in start.items():
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(dev))
                self._events.append((ev, end))
        if not self.concat and m > 1:
            out = self._head_mean(out, f, heads)
        self.wire_bytes = WireBytes(a2a, rs + self._moved)
        return out

    def _project(self, feats, w, w_skip, cols):
        """``[S][M]`` f32 ``[v_local, C]``: position (i, m)'s projected
        columns of its heads, then of the skip (``C = H·F/M`` or twice)."""
        s, m = self.s, self.m
        dl = feats[0][0].shape[1]
        blocks = [torch.cat([w[:, c], w_skip[:, c]], 1) if w_skip is not None else w[:, c]
                  for c in cols]
        w_cat = blocks[0] if m == 1 else torch.cat(blocks, 1)
        width = blocks[0].shape[1]
        placed = {}

        def on(k: int, dev: torch.device):
            if (k, dev) not in placed:
                wk = w_cat[k * dl:(k + 1) * dl].to(dev).contiguous()
                placed[k, dev] = (wk, torch.zeros(wk.shape[1], dtype=torch.float32, device=dev))
            return placed[k, dev]

        partial = [[fused_graduate(feats[i][k], *on(k, feats[i][k].device), "none")
                    for k in range(m)] for i in range(s)]
        if m == 1:
            return partial
        return [[functools.reduce(torch.add, [
            self._move(partial[i][k][:, j * width:(j + 1) * width], (i, k), (i, j))
            for k in range(m)]) for j in range(m)] for i in range(s)]

    def _dest_scores(self, st, i: int, j: int) -> torch.Tensor:
        """Source shard i's ``[S·U, H/M]`` destination scores, segment
        ``t·U + slot`` holding shard t's ``t`` at that slot (dump slots 0)."""
        rows = []
        for t in range(self.s):
            tt = st[t][j][1]
            padded = torch.cat([tt, tt.new_zeros(1, tt.shape[1])])
            picked = padded[self._gat_placed("slots", i, t, tt.device)]
            rows.append(self._move(picked, (t, j), (i, j)))
        return rows[0] if self.s == 1 else torch.cat(rows)

    def _exchange(self, parts, t: int, j: int):
        """Destination shard t's received partials ``(num, den, mx)``, flat
        over ``[S, U]`` sender-major (the tiled all_to_all)."""
        u = self._plan.slots
        got = []
        for k in range(3):
            pieces = [self._move(parts[i][j][k][t * u:(t + 1) * u], (i, j), (t, j))
                      for i in range(self.s)]
            got.append(pieces[0] if self.s == 1 else torch.cat(pieces))
        return got

    def _normalize(self, recv, skip, bias, t: int, j: int, heads: int) -> torch.Tensor:
        num, den, mx = recv
        rows, _, offsets = self._placed("dest", t, 0, num.device)
        scale = 1.0 / heads if not self.concat and self.m == 1 else 1.0
        return attention_normalize(num, den, mx, rows, offsets, bias.to(num.device),
                                   concat=self.concat, elu=self.activation, scale=scale,
                                   skip=skip)

    def _head_mean(self, partial, f: int, heads: int):
        """The output layer over M model shards: each position's sum over its
        heads, summed in model-shard order, times 1/H, and its columns kept."""
        s, m = self.s, self.m
        fm = _per_shard(f, m, "output width")
        return [[functools.reduce(torch.add, [
            self._move(partial[i][k][:, j * fm:(j + 1) * fm], (i, k), (i, j))
            for k in range(m)]) * (1.0 / heads) for j in range(m)] for i in range(s)]


def make_layer_step(mesh: Mesh, *, has_self: bool = False, activation: bool = True,
                    chunks: int = 1) -> LayerStep:
    """One broadcast GNN layer on the mesh, per-edge messages through the
    all_to_all; ``chunks`` streams the buckets in that many pieces,
    bounding the message buffer like the paper's 8 MiB chunks bound the
    reader queue.  Takes an ``EdgePlan``."""
    return LayerStep(mesh, combine=False, has_self=has_self, activation=activation,
                     chunks=chunks)


def make_combined_layer_step(mesh: Mesh, *, has_self: bool = False,
                             activation: bool = True, kind: str = "gcn", concat: bool = True,
                             tracer=NULL_TRACER) -> LayerStep:
    """Broadcast layer with source-side combining: a segment sum per
    destination BEFORE the all_to_all (wire volume E -> U).  Takes a
    ``CombinedEdgePlan``.  ``kind="gat"`` gives a ``GATLayerStep``
    (``concat``, ``tracer``; ``has_self`` does not apply); the gcn and
    sage steps trace nothing and refuse any ``tracer`` but the null one."""
    if kind == "gat":
        if has_self:
            raise ValueError("a GAT layer has no self term (its self loops are edges)")
        return GATLayerStep(mesh, concat=concat, activation=activation, tracer=tracer)
    if tracer is not NULL_TRACER:
        raise ValueError("the gcn and sage steps record no spans: only kind='gat' takes a tracer")
    return LayerStep(mesh, combine=True, has_self=has_self, activation=activation, chunks=1)


def layer_weights(spec, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """A gcn, sage or gat ``GNNLayerSpec``'s step arguments in ``dtype``:
    ``(w_agg, bias)`` for gcn; ``(w_agg, w_self, bias)`` for sage, whose
    engine weight stacks the self rows over the aggregate rows
    (``w_self = w[:D]``, ``w_agg = w[D:]``); ``(w, a_src, a_dst, bias,
    w_skip or None)`` for gat."""
    if spec.kind not in ("gcn", "sage", "gat"):
        raise ValueError(f"the mesh steps run gcn and sage layers, and gat, not {spec.kind!r}")
    if spec.kind == "gat":
        p = spec.params
        return (*(torch.as_tensor(p[k]).to(dtype) for k in ("w", "a_src", "a_dst", "b")),
                torch.as_tensor(p["w_skip"]).to(dtype) if "w_skip" in p else None)
    w = torch.as_tensor(spec.params["w"]).to(dtype)
    b = torch.as_tensor(spec.params["b"]).to(dtype)
    if spec.kind == "sage":
        return w[spec.in_dim:], w[:spec.in_dim], b
    return w, b


def run_layers(mesh: Mesh, plan, feats, specs, *, chunks: int = 1):
    """Every layer of ``specs`` (gcn, sage or gat) through the mesh:
    combined steps for a ``CombinedEdgePlan``, baseline steps of ``chunks``
    for an ``EdgePlan`` (gat takes the combined plan only).  ``feats`` is
    the padded ``[S·v_local, D]`` input (``pad_features``) in the working
    dtype; the weights are cast to it (``layer_weights``).  Returns the
    padded output as a CPU tensor and each layer's ``WireBytes``."""
    heads = [spec.heads for spec in specs if spec.kind == "gat"]
    if any(h % mesh.model_size for h in heads):
        raise ValueError(f"the GAT layers' heads {heads} must each divide by the mesh's model "
                         f"size {mesh.model_size}")
    x = shard_features(mesh, feats)
    dtype = x[0][0].dtype
    steps: dict = {}
    moved = []
    for spec in specs:
        args = layer_weights(spec, dtype)
        if spec.kind == "gat":
            key = ("gat", spec.concat, spec.activation)
            if key not in steps:
                steps[key] = make_combined_layer_step(
                    mesh, kind="gat", concat=spec.concat, activation=spec.activation)
            x = steps[key](x, plan, *args)
            moved.append(steps[key].wire_bytes)
            continue
        key = (spec.kind == "sage", spec.activation)
        if key not in steps:
            has_self, activation = key
            if isinstance(plan, CombinedEdgePlan):
                steps[key] = make_combined_layer_step(mesh, has_self=has_self,
                                                      activation=activation)
            else:
                steps[key] = make_layer_step(mesh, has_self=has_self,
                                             activation=activation, chunks=chunks)
        x = steps[key](x, plan, *args)
        moved.append(steps[key].wire_bytes)
    return gather_shards(x), moved


__all__ = [
    "CombinedEdgePlan",
    "EdgePlan",
    "LayerStep",
    "GATLayerStep",
    "Mesh",
    "WireBytes",
    "build_combined_plan",
    "build_edge_plan",
    "gather_shards",
    "layer_weights",
    "make_combined_layer_step",
    "make_layer_step",
    "pad_features",
    "pad_graph",
    "run_layers",
    "shard_features",
    "wire_bytes",
]
