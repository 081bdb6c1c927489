"""The sharded train and serving steps.  The train step is the port's
counterpart of the reference's
``jax.jit(make_train_step(cfg, opt_cfg), in_shardings=(state, batch))``
over a (data, model) or (pod, data, model) mesh (``repro/launch/train.py``);
the serving steps are described at the end.

Storage.  Every mesh position holds exactly its block of each leaf of the
parameters and both moments, as ``param_shardings`` places them (FSDP over
``data``, Megatron columns and rows over ``model``); ``step`` is
replicated.

One step, for each data shard ``i`` (its rows of the batch, as
``batch_shardings`` places them) in order:

  1. gather: each model position ``(i, m)`` copies the blocks it computes
     with into one tensor per leaf (its *view*): the whole leaf, or, for
     the split leaves, its 1/tp share of the model axis;
  2. forward and backward (autograd).  The embedding, every norm, the
     residual stream, ``lm_head`` and the loss run once, at ``(i, 0)``
     (kept whole over ``model``, where the reference splits the residual
     by sequence).  The partial outputs of every row-split projection
     (attention's and the mixers' ``wo``, the MLP's ``down``) are summed
     over ``model`` in f32, in position order, then cast.

     * Attention, where ``attention_split`` says ``"heads"``: position
       ``m`` runs its heads (K3 at ``Hq/tp``, ``Hkv/tp``) with its columns
       of ``wq/wk/wv/bq/bk/bv`` and its rows of ``wo``.  Where it says
       ``"sequence"`` (recurrentgemma's 16 query heads over 1 KV head),
       position ``m`` runs its block of query rows against the keys its
       rows can see (K3 from the window's first key, or 0, to the end of
       the block), and the blocks are concatenated.
     * The MLP (every dense, audio, vlm and hybrid layer's, the moe
       family's leading dense blocks', deepseek's shared experts and
       arctic's dense residual): its columns of ``gate/up`` and rows of
       ``down``.
     * The routed experts (moe, ``"experts"``): the routing runs once at
       ``(i, 0)`` on the whole normed rows, in f32, with the one-device
       ops (``models.moe.moe_route``), so it is one device's bits wherever
       the rows are; position ``m`` receives the rows and its experts'
       columns of the slot maps and of ``slot_gate`` (noted as
       ``collective-permute``), builds the inverse map over its own
       experts and runs its ``E/tp`` experts (``moe_experts``, with its
       slices of ``gate/up/down``).  Their outputs are summed in f32 in
       position order, then cast; within a position a token's slots are
       added in expert order.  The shared experts and the residual are
       added after, as on one device.  The router's gradient comes back to
       ``(i, 0)`` through ``slot_gate``.
     * Mamba-2 (ssm, ``"heads"``): position ``m`` runs ``H/tp`` heads: its
       columns of ``wz/wx/wdt``, its channels of ``conv_x``, its slice of
       ``a_log/dt_bias/d_skip``, K4 at ``H/tp`` heads a B/C row; ``wb/wc``
       run whole at every position (B and C serve all heads).  The gated
       norm runs over all of ``d_inner``: each position's f32 sum of
       squares over its columns is added in position order, and each
       scales its own columns by the one ``rsqrt`` and ``(1 + norm)``.
     * RG-LRU (hybrid, ``"channels"``): position ``m`` runs ``R/tp``
       channels: its columns of ``in1/in2``, its conv channels, its
       ``nb/tp`` diagonal gate blocks of ``w_r/w_i``, its ``lam``, K6 at
       ``[B, S, R/tp]``.  The recurrence is channel-local.

     The shard's loss is its tokens' cross-entropy sum over the global
     token count, so the shards' losses sum to the global mean;
  3. reduce: each view's gradient is added, in f32, into the accumulator
     of every block it overlaps, at the block's owner (the first position
     holding it), shard by shard in order and model position by position:
     one fixed order, no float atomics;

then the global gradient norm (each distinct block once, leaves in tree
order), the clip scale, and AdamW on every position's blocks with the one
scale and learning rate (``train/optimizer.py``'s ``adamw_leaf``).

The mesh's positions may share a device (``["cuda:0"] * 8`` lays a (4, 2)
mesh on one card): copies between them are then device-local.  Every
copy between two distinct positions is noted, by the collective it stands
for, to an active op record (``perf.hlo_cost.note_copy``): the FSDP gather
and the gradients' reduce, the broadcast of the residual to the model
positions and the f32 sum of their partial outputs.

With ``plan`` (the dry-run's count on ``meta``), the step runs the
forward and backward of one data shard per distinct row count and the
optimizer of one position per distinct set of block shapes, and weights
their records by how many shards or positions run the same ops
(``perf.hlo_cost.repeat``); the copies of every shard are still noted.
The state it leaves is not the step's.

The serving steps (``ShardedServeStep``: ``make_sharded_serve_prefill``
and ``make_sharded_serve_step``) are the port's counterparts of the
reference's jitted ``make_serve_prefill``/``make_serve_step`` with the
parameters placed by ``param_shardings``, the cache by ``cache_shardings``
(``shard_cache``) and the logits by ``_logits_sharding``
(``repro/launch/dryrun.py``).  They share the layout above: each call
gathers every position's view of the parameters, and the embedding, the
norms, the residual stream and ``lm_head`` run at each data shard's
first position.  The cache stays where its placement puts it: the keys
and values split by *sequence* over ``model`` (the flash-decoding
layout), so

  * prefill runs the train step's forward without grad; under
    ``"heads"`` each model position holds its heads' keys and values for
    every row and hands each other position its rows of them (an
    all-to-all); under ``"sequence"`` each already holds its own rows;
  * decode computes the new token's projections (by heads, or whole at
    the first position under ``"sequence"``), writes its keys and values
    into the block that holds slot ``length``, and every position
    attends with the queries of all heads over its own block of slots.
    The blocks' softmax statistics combine in a fixed order: the global
    max is the max of the blocks' maxima, the sum of ``exp(s - max)`` is
    added in f32 in position order, each block's probabilities are cast
    to the cache's dtype (as ``models.layers.decode_attention`` casts
    them) before its f32 PV product, and the partial products are summed
    in f32 in position order, each position receiving its heads' sum for
    its rows of ``wo``.  A block with no valid slot yet adds exact zeros.

The recurrent families' states stay where ``cache_shardings`` puts them
too: the SSM state split by heads, the conv windows and RG-LRU ``h`` by
channels, so prefill hands each position its own heads' or channels'
final states and each decode step updates them in place at the position
that owns them (no gather, no copy back).  The hybrid family's ring of
``min(window, max_len)`` slots splits by slots: prefill hands each
position the keys of its rows that the ring keeps (position ``p`` in slot
``p % ring``), and decode attends over each block with the ring's
validity (the slot holds one of the last ``ring`` positions up to the
token's) in the same fixed-order combine.

The moe family's decode splits its experts as the forward does (a
step's capacity is 1), and its layers write the KV cache by their depth
across the stacks (deepseek's moe block ``i`` into layer ``first_k_dense
+ i``).  Every family at ``tp == 1``, and the moe family where its
experts do not divide ``tp``, run the one-device
``lm.prefill``/``lm.decode_step`` at each data shard's first position on
its rows; their cache blocks are gathered there before a decode step and
the values it wrote are copied back after.  A logits tensor ``[B,
vocab]`` f32 comes back on position 0's device.  Where a position holds a
whole view or cache block itself, it is used in place: on a ``(1, 1)``
mesh the steps run exactly the one-device ops.
"""

from __future__ import annotations

import dataclasses
import math
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.annotate import attention_split
from repro_torch.distributed.sharding import (
    Placement,
    ShardedTensor,
    batch_shardings,
    cache_shardings,
    param_shardings,
    position_devices,
    replicated,
    shard_tree,
    tree_paths,
)
from repro_torch.kernels._build import CARD_TYPES
from repro_torch.models import layers as ll
from repro_torch.models import lm
from repro_torch.models import mamba as mb
from repro_torch.models import rglru as rg
from repro_torch.models.moe import moe_experts, moe_route, slot_inverse
from repro_torch.perf import hlo_cost
from repro_torch.train.optimizer import AdamWConfig, adamw_leaf, clip_scale, step_scalars

_SPLIT_FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")
# the stacks of each family in depth order, (key, kind), as lm._stacks orders them
_STACKS = {"dense": (("blocks", "dense"),), "audio": (("blocks", "dense"),),
           "vlm": (("blocks", "dense"),), "ssm": (("blocks", "mamba"),),
           "moe": (("dense_blocks", "dense"), ("moe_blocks", "moe")),
           "hybrid": (("super", "super"), ("tail", "rglru"))}
_ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm")
# the mixer leaves' split dim: wo by rows, the gate blocks by block, wb and wc
# whole at every position (B and C serve all heads), every other by its last dim
# (columns, conv channels, the norm's channels, the replicated per-head or
# per-channel vectors sliced)
_MIXER_DIMS = {"wo": -2, "w_r": -3, "w_i": -3, "wb": None, "wc": None}
# the column-split MLPs: a block's, deepseek's shared experts, arctic's dense residual
_MLPS = ("mlp", "shared", "residual")
_EPS = 1e-6  # ll.rms_norm's


def _mixer_split(cfg: lm.LMConfig, tp: int) -> str:
    """How the family's recurrent mixer splits over ``tp`` model positions:
    ``"heads"`` (Mamba-2, when its heads divide), ``"channels"`` (RG-LRU,
    when its channels and gate blocks divide), else ``"whole"``."""
    if cfg.family == "ssm":
        return "heads" if (2 * cfg.d_model // cfg.ssm_head_dim) % tp == 0 else "whole"
    if cfg.family == "hybrid":
        fits = cfg.d_rnn % tp == 0 and rg.gate_blocks(cfg.d_rnn) % tp == 0
        return "channels" if fits else "whole"
    return "whole"


def _mlp_widths(cfg: lm.LMConfig) -> list[int]:
    """The hidden width of every MLP of the config: ``d_ff``, and the moe
    family's leading dense blocks' and shared experts'."""
    widths = [cfg.d_ff]
    if cfg.family == "moe":
        if cfg.first_k_dense:
            widths.append(cfg.dense_d_ff or cfg.d_ff)
        if cfg.num_shared_experts:
            widths.append(cfg.num_shared_experts * cfg.moe_d_ff)
    return widths


def state_shardings(mesh, state) -> dict:
    """Placements of a train state: the parameters' and both moments' by
    ``param_shardings`` (FSDP over ``data``), ``step`` replicated."""
    psh = param_shardings(mesh, state["params"])
    return {"params": psh, "opt": {"m": psh, "v": psh, "step": replicated(mesh)}}


def shard_train_state(state, mesh) -> dict:
    """A one-device train state split onto ``mesh``: every position's
    blocks copied to its device."""
    return shard_tree(state, state_shardings(mesh, state))


def cache_placements(mesh, cache) -> dict:
    """Placements of a decode cache's tensors by ``cache_shardings`` (its
    ``length``, a Python int, is not placed)."""
    return cache_shardings(mesh, _cache_tensors(cache))


def shard_cache(cache, mesh) -> dict:
    """A one-device decode cache split onto ``mesh`` by
    ``cache_placements``: every position's blocks copied to its device."""
    return {**shard_tree(_cache_tensors(cache), cache_placements(mesh, cache)),
            "length": cache["length"]}


def _cache_tensors(cache) -> dict:
    return {k: v for k, v in cache.items() if k != "length"}


class _Broadcast(torch.autograd.Function):
    """``x`` copied to each device; backward: the copies' gradients summed
    in f32 in position order, then cast."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.device, ctx.dtype = x.device, x.dtype
        for _ in devices[1:]:
            hlo_cost.note_copy("all-gather", x.nbytes)
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for k, g in enumerate(grads):
            if g is not None:
                if k:
                    hlo_cost.note_copy("reduce-scatter", g.nbytes)
                g = g.to(ctx.device, torch.float32)
                total = g if total is None else total + g
        return total.to(ctx.dtype), None


class _ModelSum(torch.autograd.Function):
    """The partial outputs of the model positions summed in f32 in position
    order on ``device``, then cast to ``dtype``; backward: the gradient
    copied to each partial."""

    @staticmethod
    def forward(ctx, device, dtype, *parts):
        ctx.like = [(p.device, p.dtype) for p in parts]
        total = parts[0].to(device, torch.float32)
        for p in parts[1:]:
            hlo_cost.note_copy("reduce-scatter", p.nbytes)
            total = total + p.to(device, torch.float32)
        return total.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        for _ in ctx.like[1:]:
            hlo_cost.note_copy("all-gather", grad.nbytes)
        return (None, None, *(grad.to(d, t) for d, t in ctx.like))


class _AllReduce(torch.autograd.Function):
    """f32 parts, one a model position, summed in position order on
    ``lead`` and the sum copied back to each part's device; backward: the
    gradients the same way."""

    @staticmethod
    def forward(ctx, lead, *parts):
        ctx.lead, ctx.devices = lead, [p.device for p in parts]
        return _reduced(parts, lead, ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_reduced(grads, ctx.lead, ctx.devices))


def _reduced(parts, lead, devices) -> tuple:
    total = None
    for k, p in enumerate(parts):
        if k:
            hlo_cost.note_copy("all-reduce", p.nbytes)
        p = p.to(lead)
        total = p if total is None else total + p
    return tuple(total.to(d, copy=True) for d in devices)


class _Move(torch.autograd.Function):
    """``x`` from one model position to another; backward: its gradient
    back.  Noted as the ``kind`` and ``back`` collectives."""

    @staticmethod
    def forward(ctx, x, device, kind, back):
        ctx.device, ctx.back = x.device, back
        hlo_cost.note_copy(kind, x.nbytes)
        return x.to(device) if x.device != device else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        hlo_cost.note_copy(ctx.back, g.nbytes)
        return g.to(ctx.device), None, None, None


class _Partial(torch.autograd.Function):
    """``a @ w`` kept in f32 (the product's f32 accumulator, not rounded to
    the operands' dtype): one model position's partial output before the
    sum over ``model``.  Backward in the operands' dtype, as autograd of
    ``a @ w``."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a.device.type in CARD_TYPES and a.dtype != torch.float32:
            out = torch.mm(a2, w, out_dtype=torch.float32)
        else:
            out = a2.float() @ w.float()
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ w.transpose(0, 1)
        gw = a.reshape(-1, a.shape[-1]).transpose(0, 1) @ g.reshape(-1, g.shape[-1])
        return ga, gw


def _intersect(a: tuple[slice, ...], b: tuple[slice, ...]):
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop)) for x, y in zip(a, b))
    return None if any(s.start >= s.stop for s in out) else out


def _within(inner: tuple[slice, ...], outer: tuple[slice, ...]) -> tuple[slice, ...]:
    return tuple(slice(i.start - o.start, i.stop - o.start) for i, o in zip(inner, outer))


def _batch_region(shape, rows: slice) -> tuple[slice, ...]:
    """The whole of a cache leaf of ``shape`` but its batch dim (1): ``rows``."""
    return tuple(rows if d == 1 else slice(0, n) for d, n in enumerate(shape))


def _put(tree: dict, path: str, value) -> None:
    """``value`` at the '/'-joined ``path`` of a nested dict."""
    *parents, name = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[name] = value


def _sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


class _Layout:
    """What both sharded steps share: the mesh's positions and devices, how
    attention, the MLPs, the recurrent mixers and the experts split over
    ``model``, each
    position's view of a leaf gathered from its blocks, and the forward of
    the split families' stacks over one data shard's model positions."""

    def __init__(self, cfg: lm.LMConfig, mesh, *, plan: bool = False):
        self.cfg, self.mesh, self.plan = cfg, mesh, plan
        self.devices = position_devices(mesh)
        self.rows = mesh.positions()  # [data shard, model position] -> position
        self.tp = mesh.model_size
        self._coords = [tuple(int(c) for c in np.unravel_index(p, mesh.shape))
                        for p in range(mesh.size)]
        split = cfg.family in _SPLIT_FAMILIES and self.tp > 1
        self.mixer = _mixer_split(cfg, self.tp) if split else "whole"
        self.experts = ("experts" if split and cfg.family == "moe"
                        and cfg.num_experts % self.tp == 0 else "whole")
        # a family whose own layer cannot split runs whole
        own = {"ssm": self.mixer, "hybrid": self.mixer, "moe": self.experts}
        self.tensor_parallel = split and own.get(cfg.family) != "whole"
        attends = self.tensor_parallel and cfg.family != "ssm"
        self.attention = (attention_split(cfg.num_heads, cfg.num_kv_heads, self.tp)
                          if attends else "whole")
        self.mlp = ("columns" if attends and all(w % self.tp == 0 for w in _mlp_widths(cfg))
                    else "whole")
        self.local = cfg
        if self.attention == "heads":
            self.local = dataclasses.replace(
                cfg, num_heads=cfg.num_heads // self.tp, num_kv_heads=cfg.num_kv_heads // self.tp,
                d_ff=cfg.d_ff // self.tp)
        self._owners: dict = {}
        self._piece_cache: dict = {}

    # ------------------------------------------------------------ layout
    def modes(self, seq: int) -> tuple[str, str]:
        """How a batch of ``seq`` tokens splits attention (``"heads"``,
        ``"sequence"`` or ``"whole"``) and the MLP (``"columns"`` or
        ``"whole"``) over ``model``."""
        attn = self.attention
        if attn == "sequence" and seq % self.tp:
            attn = "whole"
        return attn, self.mlp

    def _share(self, path: str, attn: str, mlp: str) -> tuple[list[int], int | None]:
        """The model positions that compute with leaf ``path``, and the dim
        whose 1/tp share each takes (None: the whole leaf).  A leaf's
        sublayer is the key that holds it: ``super/attn/ln1`` is the
        hybrid attention layer's norm, ``super/attn/attn/wq`` its
        attention's."""
        every = list(range(self.tp))
        *parents, name = path.split("/")
        parent = parents[-1] if parents else ""
        if parent == "attn" and name in _ATTN_LEAVES and attn != "whole":
            if name in ("q_norm", "k_norm") or attn == "sequence":
                return every, None
            return every, (-2 if name == "wo" else -1)
        if parent in _MLPS and mlp == "columns" and name != "down_b":
            return every, (-2 if name == "down" else -1)
        if parent == "mixer" and self.mixer != "whole":
            return every, _MIXER_DIMS.get(name, -1)
        if parent == "moe" and self.experts == "experts" and name != "router":
            return every, -3  # the expert dim of gate, up and down
        return [0], None

    def _owner_map(self, st: ShardedTensor) -> dict:
        k = (st.placement, st.shape)
        if k not in self._owners:
            self._owners[k] = st.placement.owners(st.shape)
        return self._owners[k]

    def _nearest(self, holders: list[int], target: int) -> int:
        """The holder whose coordinates differ from ``target``'s on the
        fewest axes (the lowest position among equals)."""
        t = self._coords[target]
        return min(holders, key=lambda p: (sum(a != b for a, b in zip(self._coords[p], t)), p))

    def _region(self, shape: tuple, dim: int | None, m: int) -> tuple[slice, ...]:
        region = [slice(0, n) for n in shape]
        if dim is not None:
            d = dim % len(shape)
            w = shape[d] // self.tp
            region[d] = slice(m * w, (m + 1) * w)
        return tuple(region)

    def _pieces(self, st: ShardedTensor, region) -> list[tuple]:
        """``(key, holders, block, intersection, holder set, elements)`` of
        every distinct block of ``st`` that overlaps ``region``, in the
        owners' order."""
        k = (st.placement, st.shape, tuple((r.start, r.stop) for r in region))
        if k not in self._piece_cache:
            out = []
            for key, holders in self._owner_map(st).items():
                block = st.placement.block(st.shape, holders[0])
                inter = _intersect(block, region)
                if inter is not None:
                    out.append((key, holders, block, inter, frozenset(holders),
                                math.prod(x.stop - x.start for x in inter)))
            self._piece_cache[k] = out
        return self._piece_cache[k]

    def _runs(self, pieces: list, region) -> list[list]:
        """``pieces`` one at a time, or with ``plan`` grouped where their
        copies run the same ops: equal intersections, whole or cut along
        the same dims of the block and of ``region``."""
        if not self.plan:
            return [[p] for p in pieces]
        groups: dict[tuple, list] = {}
        for p in pieces:
            block, inter = p[2], p[3]
            key = tuple((i.stop - i.start, i == b, i == r) for i, b, r in zip(inter, block, region))
            groups.setdefault(key, []).append(p)
        return list(groups.values())

    def _view(self, st: ShardedTensor, target: int, region, *, in_place: bool = False):
        """``region`` of ``st`` on ``target``'s device, copied from the
        nearest holders of its blocks; with ``in_place``, ``target``'s own
        block where it is exactly that region."""
        if in_place and st.placement.block(st.shape, target) == tuple(region):
            return st.blocks[target]
        out = torch.empty([s.stop - s.start for s in region], dtype=st.dtype,
                          device=self.devices[target])
        for run in self._runs(self._pieces(st, region), region):
            _, holders, block, inter = run[0][:4]
            src = st.blocks[self._nearest(holders, target)]
            with hlo_cost.repeat(len(run)):
                out[_within(inter, region)].copy_(src[_within(inter, block)])
        return out

    def _note_views(self, row, leaves, attn: str, mlp: str, reduce: bool) -> None:
        """One data shard's (its positions ``row``) copies of its views
        between distinct positions: the gather of their blocks from their
        nearest holders and, with ``reduce``, the reduce of the views'
        gradients to the blocks' owners."""
        moved = {"all-gather": [0, 0], "reduce-scatter": [0, 0]}  # bytes, copies
        for path, st in leaves:
            ms, dim = self._share(path, attn, mlp)
            item = st.blocks[0].itemsize
            for m in ms:
                target = int(row[m])
                for _, holders, _, _, held, n in self._pieces(st, self._region(st.shape, dim, m)):
                    if target not in held:
                        moved["all-gather"][0] += n * item
                        moved["all-gather"][1] += 1
                    if reduce and holders[0] != target:
                        moved["reduce-scatter"][0] += n * item
                        moved["reduce-scatter"][1] += 1
        for kind, (nbytes, count) in moved.items():
            if count:
                hlo_cost.note_copy(kind, nbytes, count)

    def _shards(self, rows_of) -> list[list[int]]:
        """The data shards that run, in order, grouped: every shard its own
        group, or with ``plan`` the shards of one row count together (they
        run the same ops).  A batch not split over the shards runs once."""
        runs = [i for i, row in enumerate(self.rows)
                if not (i and rows_of(int(row[0])) == rows_of(-1))]
        if not self.plan:
            return [[i] for i in runs]
        groups: dict[int, list[int]] = {}
        for i in runs:
            r = rows_of(int(self.rows[i][0]))
            groups.setdefault(r.stop - r.start, []).append(i)
        return list(groups.values())

    def _rows_of(self, batch: dict, key: str):
        """``rows_of(pos)``: the batch rows of the data shard of position
        ``pos`` (``batch_shardings``), or of the whole batch at -1."""
        block = batch_shardings(self.mesh, batch)[key].block
        whole = tuple(batch[key].shape)
        return lambda pos: slice(0, whole[0]) if pos < 0 else block(whole, pos)[0]

    # ----------------------------------------------------------- forward
    def _attn(self, lps, h, positions, attn: str, kvs: list | None = None, window=None):
        """The attention sublayer over the model positions; with ``kvs``,
        appends the layer's keys and values, one ``(k, v)`` per computing
        position: its heads, its rows (``"sequence"``) or all."""
        p0 = lps[0]["attn"]
        if attn == "whole":
            att, kv = lm._attend(p0, self.cfg, h, positions[0], window)
            if kvs is not None:
                kvs.append([kv])
            return att @ p0["wo"]
        hs = _Broadcast.apply(h, [positions[m].device for m in range(self.tp)])
        if attn == "heads":
            outs, kv = [], []
            for m in range(self.tp):
                att, kv_m = lm._attend(lps[m]["attn"], self.local, hs[m], positions[m], window)
                outs.append(_Partial.apply(att, lps[m]["attn"]["wo"]))
                if kvs is not None:
                    kv.append(kv_m)
                del att, kv_m
            if kvs is not None:
                kvs.append(kv)
            return _ModelSum.apply(h.device, h.dtype, *outs)
        outs = [self._attn_rows(lps[m]["attn"], hs[m], positions, m, kvs is not None, window)
                for m in range(self.tp)]
        if kvs is not None:
            kvs.append([kv for _, kv in outs])
            outs = [o for o, _ in outs]
        return torch.cat([outs[0]] + [_Move.apply(o, h.device, "all-gather", "reduce-scatter")
                                      for o in outs[1:]], dim=1)

    def _attn_rows(self, p, h, positions, m: int, with_kv: bool = False, window=None):
        """Model position ``m``'s block of query rows (``"sequence"``): K3 on
        the keys from the first its rows can see (the window's start, or
        0) to the end of the block, the query rows before the block zero,
        the block's rows of the output taken; with ``with_kv``, also the
        block's rows of the keys and values."""
        cfg = self.cfg
        positions = positions[m]
        b, s, _ = h.shape
        w = s // self.tp
        lo, hi = m * w, (m + 1) * w
        first = max(0, lo - window + 1) if window else 0
        q = ll.apply_rope(lm._heads(p, cfg, h[:, lo:hi], "q", cfg.num_heads),
                          positions[lo:hi], cfg.rope_theta)
        k = ll.apply_rope(lm._heads(p, cfg, h[:, first:hi], "k", cfg.num_kv_heads),
                          positions[first:hi], cfg.rope_theta)
        v = lm._heads(p, cfg, h[:, first:hi], "v", cfg.num_kv_heads)
        att = ll.blockwise_attention(F.pad(q, (0, 0, lo - first, 0)), k, v, causal=True,
                                     window=window)[:, :, lo - first:]
        out = att.transpose(1, 2).reshape(b, w, cfg.q_dim) @ p["wo"]
        return (out, (k[:, :, lo - first:], v[:, :, lo - first:])) if with_kv else out

    def _mlp(self, lps, h, devices, mlp: str, kind: str, name: str = "mlp", hs=None):
        """The MLP ``name`` of the layer on ``h``: whole at the first
        position, or each position's columns (``h`` broadcast, or ``hs``
        its copies) summed over ``model``."""
        p0 = lps[0][name]
        if mlp == "whole":
            return ll.mlp_forward(p0, h, kind)
        hs = _Broadcast.apply(h, devices) if hs is None else hs
        outs = [_Partial.apply(ll.mlp_hidden(lps[m][name], hs[m], kind), lps[m][name]["down"])
                for m in range(self.tp)]
        y = _ModelSum.apply(h.device, h.dtype, *outs)  # the bias once, after the sum
        return y + p0["down_b"] if "down_b" in p0 else y

    def _moe(self, lps, h, devices, mlp: str):
        """The moe block's FFN on the normed ``h`` (``lm._moe_ffn``), each
        model position on its ``E/tp`` experts: the routing once at the
        first position, whole and in f32 (the one-device ops); each
        position gets ``h`` and its experts' columns of the slot maps and
        of ``slot_gate``, builds its inverse map over them and runs
        ``moe_experts``; the routed outputs are summed in f32 in position
        order, cast, then the shared experts and the residual added (both
        column-split MLPs), in the one-device order."""
        cfg = self.cfg
        p0 = lps[0]
        b, s, _ = h.shape
        fwd, slot_gate = moe_route(p0["moe"]["router"], h, cfg.top_k, cfg.capacity_factor)
        hs = _Broadcast.apply(h, devices)
        e, cap = cfg.num_experts // self.tp, slot_gate.shape[-1]
        slots = fwd.reshape(b, cfg.num_experts, cap)
        outs = []
        for m in range(self.tp):
            fwd_m = slots[:, m * e:(m + 1) * e].reshape(b, e * cap)
            gate_m = slot_gate[:, m * e:(m + 1) * e]
            if m:
                hlo_cost.note_copy("collective-permute", fwd_m.nbytes)
                fwd_m = fwd_m.to(devices[m])
                gate_m = _Move.apply(gate_m, devices[m], "collective-permute",
                                     "collective-permute")
            pm = lps[m]["moe"]
            outs.append(moe_experts(pm["gate"], pm["up"], pm["down"], hs[m], fwd_m,
                                    slot_inverse(fwd_m, s, cfg.top_k), gate_m))
        y = _ModelSum.apply(h.device, h.dtype, *outs)
        for name in ("shared", "residual"):
            if name in p0:
                y = y + self._mlp(lps, h, devices, mlp, cfg.mlp_kind, name, hs)
        return y

    def _ffn(self, x, lps, devices, mlp: str, kind: str):
        """A block's second sublayer on ``ln2`` of ``x``, added to ``x``: the
        MLP of ``kind``, or (``"moe"``) the moe FFN."""
        h = ll.rms_norm(x, lps[0]["ln2"])
        if kind == "moe":
            return x + self._moe(lps, h, devices, mlp)
        return x + self._mlp(lps, h, devices, mlp, kind)

    def _block(self, x, lps, positions, attn: str, mlp: str, kvs: list | None = None,
               window=None, kind=None):
        """An attention-and-FFN block: the dense families' layer, the moe
        family's (``kind`` ``"moe"``), or the hybrid family's attention
        layer (``window``, a geglu MLP)."""
        x = x + self._attn(lps, ll.rms_norm(x, lps[0]["ln1"]), positions, attn, kvs, window)
        return self._ffn(x, lps, [t.device for t in positions], mlp, kind or self.cfg.mlp_kind)

    def _gated_norm(self, ys: list, zs: list, norms: list) -> list:
        """The Mamba-2 gated norm ``rms_norm(y, norm) * silu(z)`` over all of
        ``d_inner`` when each model position holds its heads' columns of
        ``y``: each position's f32 sum of squares over its columns, added
        in position order (``_AllReduce``); each position scales its own
        columns by the one ``rsqrt`` and ``(1 + norm)`` in f32, then casts
        (what K5 computes on the whole row, written out)."""
        width = sum(y.shape[-1] for y in ys)
        sums = _AllReduce.apply(ys[0].device, *(torch.sum(torch.square(y.float()), dim=-1,
                                                          keepdim=True) for y in ys))
        return [(y.float() * torch.rsqrt(t / width + _EPS) * (1.0 + n.float())).to(y.dtype)
                * F.silu(z) for y, z, n, t in zip(ys, zs, norms, sums)]

    def _mixer_out(self, lps, ys: list, x):
        """The partial products of each position's columns with its rows of
        the mixer's ``wo``, summed in f32 in position order, cast."""
        return _ModelSum.apply(x.device, x.dtype, *(_Partial.apply(y, lps[m]["mixer"]["wo"])
                                                    for m, y in enumerate(ys)))

    def _mamba(self, x, lps, positions, states: list | None = None):
        """A Mamba-2 layer, each model position on its heads (K4 at
        ``H/tp``); with ``states``, appends each position's decode cache."""
        cfg = self.cfg
        h = ll.rms_norm(x, lps[0]["ln1"])
        hs = _Broadcast.apply(h, [t.device for t in positions])
        ys, zs, caches = [], [], []
        for m in range(self.tp):
            y, z, cache = mb.mamba_inner(lps[m]["mixer"], hs[m], head_dim=cfg.ssm_head_dim,
                                         chunk=cfg.ssd_chunk, return_cache=states is not None)
            ys.append(y)
            zs.append(z)
            caches.append(cache)
        if states is not None:
            states.append(caches)
        ys = self._gated_norm(ys, zs, [lp["mixer"]["norm"] for lp in lps])
        return x + self._mixer_out(lps, ys, x)

    def _rglru(self, x, lps, positions, mlp: str, states: list | None = None):
        """An RG-LRU layer, each model position on its channels (K6 at
        ``R/tp``), then its geglu MLP; with ``states``, appends each
        position's decode cache."""
        devices = [t.device for t in positions]
        h = ll.rms_norm(x, lps[0]["ln1"])
        hs = _Broadcast.apply(h, devices)
        outs = [rg.rglru_inner(lps[m]["mixer"], hs[m], return_cache=states is not None)
                for m in range(self.tp)]
        if states is not None:
            states.append([c for _, c in outs])
        x = x + self._mixer_out(lps, [y for y, _ in outs], x)
        return self._ffn(x, lps, devices, mlp, "geglu")

    def _super(self, x, lps, positions, attn: str, mlp: str, kvs: list | None = None,
               states: dict | None = None):
        """A Griffin superblock: two RG-LRU layers, then local attention."""
        for name in ("r1", "r2"):
            x = self._rglru(x, [lp[name] for lp in lps], positions, mlp,
                            None if states is None else states.setdefault(name, []))
        return self._block(x, [lp["attn"] for lp in lps], positions, attn, mlp, kvs,
                           self.cfg.window, "geglu")

    def _layer(self, kind: str, x, lps, positions, attn: str, mlp: str, kvs=None, states=None):
        if kind == "mamba":
            return self._mamba(x, lps, positions, None if states is None
                               else states.setdefault("layers", []))
        if kind == "rglru":
            return self._rglru(x, lps, positions, mlp, None if states is None
                               else states.setdefault("tail", []))
        if kind == "super":
            return self._super(x, lps, positions, attn, mlp, kvs, states)
        return self._block(x, lps, positions, attn, mlp, kvs, kind="moe" if kind == "moe" else None)

    def _stacks(self, trees: list[dict]) -> list[tuple[str, list]]:
        """The stacks in depth order, each ``(kind, layers)``: ``layers[i][m]``
        model position ``m``'s views of layer ``i`` (``{}`` where it holds
        none of them)."""
        out = []
        for name, kind in _STACKS[self.cfg.family]:
            if name not in trees[0]:
                continue
            depth = lm._depth(trees[0][name])
            per = [lm._unstack(t[name], depth) if name in t else [{}] * depth for t in trees]
            out.append((kind, [[per[m][i] for m in range(len(trees))] for i in range(depth)]))
        return out

    def _hidden(self, trees: list[dict], inputs, positions, attn: str, mlp: str,
                kvs: list | None = None, states: dict | None = None):
        """The final-normed hidden rows of one data shard; with ``kvs`` and
        ``states`` (prefill), the keys and values and the recurrent layers'
        decode caches appended.  With autograd recording and ``remat``,
        each block (a hybrid superblock whole) is checkpointed, as
        ``lm.forward_hidden`` does."""
        cfg = self.cfg
        if not self.tensor_parallel:
            return lm.forward_hidden(trees[0], cfg, inputs, positions[0])
        x = lm._embed(trees[0], cfg, inputs)
        remat = cfg.remat and torch.is_grad_enabled()
        for kind, layers in self._stacks(trees):
            for lps in layers:
                if remat:
                    x = torch.utils.checkpoint.checkpoint(self._layer, kind, x, lps, positions,
                                                          attn, mlp, use_reentrant=False)
                else:
                    x = self._layer(kind, x, lps, positions, attn, mlp, kvs, states)
        return ll.rms_norm(x, trees[0]["final_norm"])


class ShardedTrainStep(_Layout):
    """``step(state, batch) -> (state, metrics)`` on a sharded state
    (``shard_train_state``), updated in place; ``metrics`` hold ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim f32 tensors on position 0's device.

    ``loss_and_grads`` and ``apply`` are the step's two halves; ``apply``
    takes an explicit clip ``scale`` too.  With ``timed``, ``seconds``
    holds the last step's seconds of gather, forward_backward, reduce and
    optimizer (host clock, the devices synchronized at each boundary)."""

    def __init__(self, cfg: lm.LMConfig, opt_cfg: AdamWConfig, mesh, *, timed: bool = False,
                 plan: bool = False):
        super().__init__(cfg, mesh, plan=plan)
        self.opt_cfg, self.timed = opt_cfg, timed
        self.seconds: dict[str, float] = {}

    # ------------------------------------------------------------- a step
    def _tick(self, name: str, t0: float) -> float:
        if not self.timed:
            return t0
        _sync(self.devices)
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - t0
        return now

    def _accumulators(self, st: ShardedTensor) -> dict:
        """f32 zeros for every distinct block of ``st`` on its owner (with
        ``plan``, the first block's fill counted for all: they are equal)."""
        owners = self._owner_map(st)
        shape = [s.stop - s.start for s in st.placement.block(st.shape, 0)]
        out = {}
        for n, (k, h) in enumerate(owners.items()):
            dev = self.devices[h[0]]
            if not self.plan:
                out[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
            elif n == 0:
                with hlo_cost.repeat(len(owners)):
                    out[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
            else:
                out[k] = torch.empty(shape, dtype=torch.float32, device=dev)
        return out

    def _note_shard_copies(self, i: int, leaves, attn: str, mlp: str) -> None:
        """Data shard ``i``'s copies between distinct positions: the gather
        of its views' blocks from their nearest holders, the reduce of its
        views' gradients to the blocks' owners, its loss to position 0."""
        row = self.rows[i]
        self._note_views(row, leaves, attn, mlp, reduce=True)
        if int(row[0]):
            hlo_cost.note_copy("all-reduce", 4)

    def _shard_pass(self, row, rows_of, batch: dict, key: str, leaves, acc: dict, attn: str,
                    mlp: str, n_tokens: int, t: float) -> tuple:
        """One data shard (its positions ``row``): gather its views, its
        forward and backward, its gradients added into ``acc``.  Returns its
        share of the loss (detached) and the clock."""
        seq = batch[key].shape[1]
        first = int(row[0])
        rows = rows_of(first)
        views, trees = [], [{} for _ in range(self.tp)]
        for path, st in leaves:
            ms, dim = self._share(path, attn, mlp)
            for m in ms:
                region = self._region(st.shape, dim, m)
                v = self._view(st, int(row[m]), region).requires_grad_()
                views.append((path, st, region, v))
                _put(trees[m], path, v)
        t = self._tick("gather", t)
        dev = self.devices[first]
        positions = [torch.arange(seq, device=self.devices[int(p)]) for p in row]
        with torch.enable_grad():
            h = self._hidden(trees, batch[key][rows].to(dev), positions, attn, mlp)
            logits = (h @ trees[0]["lm_head"]).to(torch.float32)
            labels = batch["labels"][rows].to(dev).long()
            ce = (torch.logsumexp(logits, dim=-1)
                  - torch.gather(logits, -1, labels[..., None])[..., 0])
            part = ce.sum() / n_tokens
            del h, logits, ce
            grads = torch.autograd.grad(part, [v for *_, v in views])
        t = self._tick("forward_backward", t)
        for (path, st, region, _), g in zip(views, grads):
            for run in self._runs(self._pieces(st, region), region):
                k, _, block, inter = run[0][:4]
                a = acc[path][k]
                with hlo_cost.repeat(len(run)):
                    a[_within(inter, block)] += g[_within(inter, region)].to(a.device,
                                                                              torch.float32)
        return part.detach(), self._tick("reduce", t)

    def loss_and_grads(self, params: dict, batch: dict) -> tuple:
        """The global loss (f32, position 0's device) and the gradients: a
        tree like ``params`` of f32 ``ShardedTensor``s on its placements."""
        self.seconds = {}
        key = "tokens" if self.cfg.input_mode == "tokens" else "embeddings"
        attn, mlp = self.modes(batch[key].shape[1])
        n_tokens = batch["labels"].numel()
        rows_of = self._rows_of(batch, key)
        leaves = tree_paths(params)
        acc = {path: self._accumulators(st) for path, st in leaves}
        parts = []
        t = time.perf_counter()
        for group in self._shards(rows_of):
            if hlo_cost.tracing():
                for i in group:
                    self._note_shard_copies(i, leaves, attn, mlp)
            # the shards that run alike: the others' shares held as the last one's
            # pass would find them, then that pass
            parts += [torch.empty((), dtype=torch.float32, device=self.devices[0])
                      for _ in group[1:]]
            with hlo_cost.repeat(len(group)):
                part, t = self._shard_pass(self.rows[group[0]], rows_of, batch, key, leaves,
                                           acc, attn, mlp, n_tokens, t)
            parts.append(part)
        loss = None
        for part in parts:
            part = part.to(self.devices[0])
            loss = part if loss is None else loss + part
        out = {}
        for path, st in leaves:
            owners = self._owner_map(st)
            blocks = [None] * self.mesh.size
            copies = 0
            for k, holders in owners.items():
                copies += len(holders) - 1
                for p in holders:
                    blocks[p] = acc[path][k].to(self.devices[p])
            if copies:  # the reduced blocks to the other positions holding them
                hlo_cost.note_copy("all-gather", copies * blocks[0].nbytes, copies)
            _put(out, path, ShardedTensor(st.placement, st.shape, blocks))
        self._tick("reduce", t)
        return loss, out

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the f32 sum of squares of every distinct gradient block,
        leaves in tree order, blocks in their owners' order."""
        dev0 = self.devices[0]
        total = None
        for _, g in tree_paths(grads):
            owners = [h[0] for h in self._owner_map(g).values()]
            remote = sum(1 for p in owners if p)
            if remote:
                hlo_cost.note_copy("all-reduce", 4 * remote, remote)
            if not self.plan:
                runs = [[p] for p in owners]
            else:  # equal blocks run equal ops; the first block of all adds nothing
                runs = [owners[:1], owners[1:]] if total is None else [owners]
            for run in runs:
                if not run:
                    continue
                with hlo_cost.repeat(len(run)):
                    sq = torch.sum(g.blocks[run[0]].to(torch.float32).square()).to(dev0)
                    total = sq if total is None else total + sq
        return torch.sqrt(total)

    def _position_groups(self, state: dict) -> list[list[int]]:
        """The positions whose optimizer runs, grouped: each its own, or with
        ``plan`` those holding blocks of equal shapes together."""
        if not self.plan:
            return [[p] for p in range(self.mesh.size)]
        leaves = [st for tree in (state["params"], state["opt"]["m"], state["opt"]["v"])
                  for _, st in tree_paths(tree)]
        groups: dict[tuple, list[int]] = {}
        for p in range(self.mesh.size):
            sig = tuple((tuple(st.blocks[p].shape), st.blocks[p].dtype) for st in leaves)
            groups.setdefault(sig, []).append(p)
        return list(groups.values())

    @torch.no_grad()
    def apply(self, state: dict, grads: dict, scale: torch.Tensor | None = None) -> tuple:
        """AdamW on every position's blocks, in place: ``(state, metrics)``.
        ``scale`` (default: ``clip_scale`` of ``global_norm(grads)``)."""
        t = time.perf_counter()
        opt, dev0 = state["opt"], self.devices[0]
        gnorm = self.global_norm(grads)
        scale = clip_scale(self.opt_cfg, gnorm) if scale is None else scale.to(dev0)
        step = opt["step"].blocks[0] + 1
        k = step_scalars(self.opt_cfg, step)
        for _ in range(self.mesh.size - 1):  # the four scalars to every other position
            hlo_cost.note_copy("all-gather", 16)
        per_device = {d: [x.to(d) for x in (scale, k["lr"], k["bc1"], k["bc2"])]
                      for d in set(self.devices)}
        leaves = list(zip(tree_paths(state["params"]), tree_paths(grads), tree_paths(opt["m"]),
                          tree_paths(opt["v"])))
        for group in self._position_groups(state):
            pos = group[0]
            with hlo_cost.repeat(len(group)):
                for (_, p), (_, g), (_, m), (_, v) in leaves:
                    adamw_leaf(p.blocks[pos], g.blocks[pos], m.blocks[pos], v.blocks[pos],
                               self.opt_cfg, *per_device[self.devices[pos]])
        opt["step"].blocks = [s + 1 for s in opt["step"].blocks]
        self._tick("optimizer", t)
        return state, {"grad_norm": gnorm, "lr": k["lr"]}

    def __call__(self, state: dict, batch: dict) -> tuple:
        loss, grads = self.loss_and_grads(state["params"], batch)
        state, metrics = self.apply(state, grads)
        metrics["loss"] = loss
        return state, metrics


def make_sharded_train_step(cfg: lm.LMConfig, opt_cfg: AdamWConfig, mesh, *,
                            timed: bool = False) -> ShardedTrainStep:
    """The train step on ``mesh`` (see the module docstring)."""
    return ShardedTrainStep(cfg, opt_cfg, mesh, timed=timed)


class ShardedServeStep(_Layout):
    """``prefill(params, batch) -> (logits, cache)`` and ``decode(params,
    cache, batch) -> (logits, cache)`` on parameters placed by
    ``param_shardings`` and a cache of ``ShardedTensor``s placed by
    ``cache_placements`` (see the module docstring).  ``decode`` writes
    into the cache's blocks in place.  With ``plan``, one data shard runs
    per distinct row count, its records weighted by how many run alike;
    the cache and logits it returns are then not the step's.

    A decode step splits attention by ``attention``: ``"heads"`` computes
    the projections by heads, ``"sequence"`` whole at the first position,
    and both attend over each position's block of slots; the recurrent
    mixers split by ``mixer``, each position stepping its own states, and
    the moe family's experts by ``experts``."""

    # ------------------------------------------------------------ helpers
    def _send(self, t: torch.Tensor, src: int, dst: int, kind: str) -> torch.Tensor:
        """``t`` from position ``src`` to ``dst``, noted as part of ``kind``
        where they differ."""
        if src != dst:
            hlo_cost.note_copy(kind, t.nbytes)
        return t.to(self.devices[dst])

    def _collect(self, parts: list, dst: int, kind: str) -> torch.Tensor:
        """``[(position, tensor)]`` concatenated over heads (dim 1) at ``dst``."""
        moved = [self._send(t, p, dst, kind) for p, t in parts]
        return moved[0] if len(moved) == 1 else torch.cat(moved, dim=1)

    def _views(self, params: dict, row, attn: str, mlp: str) -> list[dict]:
        """Each model position's tree of views of the parameters."""
        trees: list[dict] = [{} for _ in range(self.tp)]
        for path, st in tree_paths(params):
            ms, dim = self._share(path, attn, mlp)
            for m in ms:
                _put(trees[m], path, self._view(st, int(row[m]), self._region(st.shape, dim, m),
                                                in_place=True))
        return trees

    def _logits(self, parts: list) -> torch.Tensor:
        """The shards' ``[(position, logits)]`` as one tensor on position 0."""
        moved = [self._send(t, p, 0, "all-gather") for p, t in parts]
        return moved[0] if len(moved) == 1 else torch.cat(moved)

    def _holders(self, st: ShardedTensor, region) -> list[int]:
        """The positions whose block of ``st`` overlaps ``region``."""
        return [p for p in range(self.mesh.size)
                if _intersect(st.placement.block(st.shape, p), region) is not None]

    def _run_shards(self, params, batch: dict, shard_fn, attn: str, mlp: str):
        """``shard_fn(row, rows, inputs)`` for every data shard that runs
        (with ``plan`` one per row count, weighted): its positions, its
        batch rows and their inputs on its first position's device.  Its
        views' copies are noted for every shard; the logits of all come
        back as one tensor on position 0."""
        key = "tokens" if self.cfg.input_mode == "tokens" else "embeddings"
        rows_of = self._rows_of(batch, key)
        leaves = tree_paths(params)
        parts = []
        for group in self._shards(rows_of):
            if hlo_cost.tracing():
                for i in group:
                    self._note_views(self.rows[i], leaves, attn, mlp, reduce=False)
            with hlo_cost.repeat(len(group)):
                row = self.rows[group[0]]
                first = int(row[0])
                rows = rows_of(first)
                logits = shard_fn(row, rows, batch[key][rows].to(self.devices[first]))
            parts.append((first, logits))
            for i in group[1:]:  # the shards that ran alike, as their pass would leave them
                parts.append((int(self.rows[i][0]), torch.empty_like(
                    logits, device=self.devices[int(self.rows[i][0])])))
        return self._logits(parts)

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict) -> tuple:
        """The prompt's last-token logits ``[B, vocab]`` f32 on position 0
        and the cache, its tensors ``ShardedTensor``s by ``cache_placements``
        and its ``length`` the prompt's."""
        cfg = self.cfg
        key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
        b, seq = batch[key].shape[:2]
        attn, mlp = self.modes(seq)
        leaves: dict = {}  # path -> [shape, dtype, placement, blocks], from the first shard

        def shard(row, rows, inputs):
            trees = self._views(params, row, attn, mlp)
            first = int(row[0])
            if not self.tensor_parallel:
                logits, local = lm.prefill(trees[0], cfg, inputs)
                local = tree_paths(_cache_tensors(local))
                found = {path: (t.shape[0], b, *t.shape[2:]) for path, t in local}
                sources = {path: [(first, _batch_region(found[path], rows), t)]
                           for path, t in local}
                kind = "collective-permute"
            else:
                positions = [torch.arange(seq, device=self.devices[int(p)]) for p in row]
                kvs: list = []
                states: dict = {}
                h = self._hidden(trees, inputs, positions, attn, mlp, kvs, states)
                logits = (h[:, -1] @ trees[0]["lm_head"]).to(torch.float32)
                del h
                found, sources = self._state_sources(states, row, rows, b)
                if kvs:
                    ring = min(cfg.window, seq) if cfg.family == "hybrid" else seq
                    shape = (len(kvs), b, cfg.num_kv_heads, ring, cfg.head_dim)
                    for j, path in enumerate(("k", "v")):
                        found[path] = shape
                        sources[path] = self._kv_sources(kvs, j, row, rows, shape, attn, seq)
                del kvs, states
                kind = "all-to-all" if attn == "heads" else "collective-permute"
            if not leaves:
                like: dict = {}
                for path, shape in found.items():
                    _put(like, path, SimpleNamespace(shape=shape, ndim=len(shape)))
                for path, pl in tree_paths(cache_shardings(self.mesh, like)):
                    leaves[path] = [found[path], sources[path][0][2].dtype, pl,
                                    [None] * self.mesh.size]
            for path, (shape, dtype, pl, blocks) in leaves.items():
                self._hand_off(pl, shape, dtype, sources.pop(path), rows, blocks, kind)
            return logits

        logits = self._run_shards(params, batch, shard, attn, mlp)
        cache: dict = {}
        for path, (shape, dtype, pl, blocks) in leaves.items():
            block = [r.stop - r.start for r in pl.block(shape, 0)]
            _put(cache, path, ShardedTensor(pl, shape, [
                t if t is not None else torch.empty(block, dtype=dtype, device=self.devices[p])
                for p, t in enumerate(blocks)]))
        cache["length"] = seq
        return logits, cache

    def _kv_sources(self, kvs: list, which: int, row, rows: slice, shape, attn: str,
                    seq: int) -> list:
        """``[(position, region, tensor)]`` of the prefill's keys
        (``which`` 0) or values (1): each computing position's layers
        stacked, over its heads (``"heads"``), its rows (``"sequence"``) or
        all (``"whole"``).  The cache keeps the last ``shape[3]`` positions,
        position ``p`` in slot ``p % shape[3]`` (all of them in order but
        for the hybrid family's ring), so a position's rows may wrap into
        two runs of slots."""
        ring = shape[3]
        out = []
        for m in range(len(kvs[0])):
            t = torch.stack([layer[m][which] for layer in kvs])
            region = list(_batch_region(shape, rows))
            lo = m * (seq // self.tp) if attn == "sequence" else 0
            if attn == "heads":
                w = shape[2] // self.tp
                region[2] = slice(m * w, (m + 1) * w)
            first = max(lo, seq - ring)  # the first of its rows the cache keeps
            t = t[:, :, :, first - lo:]
            start = first % ring
            for s0, piece in ((start, t[:, :, :, :ring - start]), (0, t[:, :, :, ring - start:])):
                if piece.shape[3]:
                    region[3] = slice(s0, s0 + piece.shape[3])
                    out.append((int(row[m]), tuple(region), piece))
        return out

    def _state_sources(self, states: dict, row, rows: slice, b: int) -> tuple[dict, dict]:
        """The recurrent layers' decode caches the prefill appended (per
        stack, per layer, per model position): each cache path's whole
        shape and its ``[(position, region, tensor)]``, each position's
        layers stacked over its heads or channels (the conv windows' last
        dim, the SSM state's and RG-LRU ``h``'s dim 2)."""
        found, sources = {}, {}
        for name, layers in states.items():
            for key in layers[0][0]:
                dim = 3 if key == "conv" else 2
                parts = [torch.stack([layer[m][key] for layer in layers]) for m in range(self.tp)]
                shape = list(parts[0].shape)
                shape[1], shape[dim] = b, shape[dim] * self.tp
                path = f"{name}/{key}"
                found[path] = tuple(shape)
                sources[path] = []
                for m, t in enumerate(parts):
                    region = list(_batch_region(found[path], rows))
                    w = t.shape[dim]
                    region[dim] = slice(m * w, (m + 1) * w)
                    sources[path].append((int(row[m]), tuple(region), t))
        return found, sources

    def _hand_off(self, pl: Placement, shape: tuple, dtype, sources: list, rows: slice,
                  blocks: list, kind: str) -> None:
        """``blocks[p]`` for every position ``p`` whose block holds some of
        the shard's ``rows``, assembled from ``sources`` (``[(position,
        region, tensor)]``), each piece that crosses positions noted as
        ``kind``; a source that is exactly ``p``'s block becomes it."""
        batch = _batch_region(shape, rows)
        for p in range(self.mesh.size):
            region = pl.block(shape, p)
            if _intersect(region, batch) is None:
                continue
            pieces = [(q, r, t) for q, r, t in sources if _intersect(region, r) is not None]
            if (len(pieces) == 1 and pieces[0][0] == p and pieces[0][1] == region
                    and pieces[0][2].is_contiguous()):
                blocks[p] = pieces[0][2]
                continue
            out = torch.empty([r.stop - r.start for r in region], dtype=dtype,
                              device=self.devices[p])
            for q, r, t in pieces:
                inter = _intersect(region, r)
                piece = t[_within(inter, r)]
                if q != p:
                    hlo_cost.note_copy(kind, piece.nbytes)
                out[_within(inter, region)].copy_(piece)
            blocks[p] = out

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode(self, params: dict, cache: dict, batch: dict) -> tuple:
        """One token for the whole batch: the logits ``[B, vocab]`` f32 on
        position 0 and ``cache``, its blocks written in place and its
        ``length`` advanced."""
        pos = cache["length"]
        attn, mlp = self.attention, self.mlp
        leaves = tree_paths(_cache_tensors(cache))

        def shard(row, rows, inputs):
            if not self.tensor_parallel:
                return self._decode_whole(params, leaves, row, rows, inputs, pos)
            return self._decode_split(params, cache, row, rows, inputs, pos, attn, mlp)

        logits = self._run_shards(params, batch, shard, "heads" if attn == "heads" else "whole",
                                  mlp)
        cache["length"] = pos + 1
        return logits, cache

    def _decode_whole(self, params, leaves, row, rows, inputs, pos: int):
        """``lm.decode_step`` at the shard's first position on its rows: its
        cache blocks gathered there, the values it wrote copied back."""
        first = int(row[0])
        trees = self._views(params, row, "whole", "whole")
        local: dict = {}
        gathered = []
        for path, st in leaves:
            region = _batch_region(st.shape, rows)
            view = self._view(st, first, region, in_place=True)
            if view is not st.blocks[first]:
                moved = sum(n for *_, held, n in self._pieces(st, region) if first not in held)
                if moved:
                    hlo_cost.note_copy("all-gather", moved * st.blocks[0].itemsize)
                gathered.append((path, st, region, view))
            _put(local, path, view)
        local["length"] = pos
        logits, _ = lm.decode_step(trees[0], self.cfg, local, inputs)
        for path, st, region, view in gathered:
            written = list(region)
            if path.rsplit("/", 1)[-1] in ("k", "v"):  # one slot of the keys and values
                slot = pos % st.shape[3]
                written[3] = slice(slot, slot + 1)
            written = tuple(written)
            for p in self._holders(st, written):
                block = st.placement.block(st.shape, p)
                inter = _intersect(block, written)
                piece = view[_within(inter, region)]
                if p != first:
                    hlo_cost.note_copy("collective-permute", piece.nbytes)
                st.blocks[p][_within(inter, block)].copy_(piece)
        return logits

    def _decode_split(self, params, cache, row, rows, inputs, pos: int, attn: str, mlp: str):
        """The split families' decode over the shard's model positions (see
        the module docstring): each stack's layers in depth order, the
        recurrent states of each position's heads or channels updated in
        its own cache blocks."""
        cfg = self.cfg
        trees = self._views(params, row, "heads" if attn == "heads" else "whole", mlp)
        devices = [self.devices[int(p)] for p in row]
        posv = [torch.full((1,), pos, dtype=torch.int64, device=d) for d in devices]
        kv = None
        if "k" in cache:
            kc, vc = cache["k"], cache["v"]
            ring = kc.shape[3] if cfg.family == "hybrid" else None
            slot = pos % ring if ring else pos
            spans = [kc.placement.block(kc.shape, int(p))[3] for p in row]
            region = (slice(0, kc.shape[0]), rows, slice(0, kc.shape[2]), slice(slot, slot + 1),
                      slice(0, kc.shape[4]))
            kv = SimpleNamespace(
                k=kc, v=vc, ring=ring, slot=slot, spans=spans, holders=self._holders(kc, region),
                owners=[m for m in range(self.tp) if spans[m] not in spans[:m]],  # distinct blocks
                angles=[ll.rope_angles(posv[m], cfg.head_dim, cfg.rope_theta)  # every layer's
                        for m in range(self.tp if attn == "heads" else 1)])
        x = lm._embed(trees[0], cfg, inputs)
        a = 0  # the attention layer's slot in the KV cache, across the stacks
        for kind, layers in self._stacks(trees):
            for i, lps in enumerate(layers):
                if kind == "mamba":
                    x = self._mamba_step(x, lps, row, rows, cache["layers"], i)
                elif kind == "rglru":
                    x = self._rglru_step(x, lps, row, rows, cache["tail"], i, mlp)
                elif kind == "super":
                    for name in ("r1", "r2"):
                        x = self._rglru_step(x, [lp[name] for lp in lps], row, rows, cache[name],
                                             i, mlp)
                    x = self._attn_step(x, [lp["attn"] for lp in lps], row, attn, mlp, kv, a, pos,
                                        "geglu")
                    a += 1
                else:
                    x = self._attn_step(x, lps, row, attn, mlp, kv, a, pos,
                                        "moe" if kind == "moe" else cfg.mlp_kind)
                    a += 1
        h = ll.rms_norm(x, trees[0]["final_norm"])
        return (h[:, 0] @ trees[0]["lm_head"]).to(torch.float32)

    def _attn_step(self, x, lps, row, attn: str, mlp: str, kv, layer: int, pos: int, kind: str):
        """One token through an attention-and-FFN layer: its keys and values
        written into the slot of ``pos`` of cache layer ``layer``, attention
        over every position's block of slots, then the MLP of ``kind`` or
        (``"moe"``) the moe FFN, its capacity 1."""
        cfg = self.cfg
        first = int(row[0])
        p0 = lps[0]
        h = ll.rms_norm(x, p0["ln1"])
        if attn == "heads":
            hs = _Broadcast.apply(h, [self.devices[int(p)] for p in row])
            q, k, v = [], [], []
            for m in range(self.tp):
                qm, km, vm = lm._qkv(lps[m]["attn"], self.local, hs[m])
                q.append((int(row[m]), ll.rotate(qm, *kv.angles[m])))
                k.append((int(row[m]), ll.rotate(km, *kv.angles[m])))
                v.append((int(row[m]), vm))
            del hs
        else:
            qm, km, vm = lm._qkv(p0["attn"], cfg, h)
            q = [(first, ll.rotate(qm, *kv.angles[0]))]
            k = [(first, ll.rotate(km, *kv.angles[0]))]
            v = [(first, vm)]
        for p in kv.holders:  # the new token's keys and values, all heads, into its slot
            at = kv.slot - kv.k.placement.block(kv.k.shape, p)[3].start
            kv.k.blocks[p][layer, :, :, at] = self._collect(k, p, "all-gather")[:, :, 0]
            kv.v.blocks[p][layer, :, :, at] = self._collect(v, p, "all-gather")[:, :, 0]
        pv = self._attend_blocks(q, kv, layer, row, pos)
        x = x + self._attn_out(pv, lps, row, attn, x)
        return self._ffn(x, lps, [self.devices[int(p)] for p in row], mlp, kind)

    def _states(self, st: dict, row, rows: slice, layer: int) -> list[dict]:
        """Each model position's cache of layer ``layer`` of a recurrent
        stack: its own block's rows, heads or channels, read in place."""
        out = []
        for m in range(self.tp):
            p = int(row[m])
            views = {}
            for key, t in st.items():
                dim = 3 if key == "conv" else 2
                w = t.shape[dim] // self.tp
                region = list(_batch_region(t.shape, rows))
                region[dim] = slice(m * w, (m + 1) * w)
                if t.placement.block(t.shape, p) != tuple(region):
                    raise ValueError(f"cache {key}: position {p}'s block is not its share")
                views[key] = t.blocks[p][layer]
            out.append(views)
        return out

    def _write_states(self, st: dict, row, rows: slice, layer: int, new: list[dict]) -> None:
        """Each position's new state into its own block, in place, and into
        every other position holding that region (a replica)."""
        for m, values in enumerate(new):
            p = int(row[m])
            for key, t in st.items():
                block = t.placement.block(t.shape, p)
                t.blocks[p][layer].copy_(values[key])
                for q in self._holders(t, block):
                    if q != p and t.placement.block(t.shape, q) == block:
                        hlo_cost.note_copy("collective-permute", values[key].nbytes)
                        t.blocks[q][layer].copy_(values[key])

    def _mamba_step(self, x, lps, row, rows: slice, st: dict, layer: int):
        """One token through a Mamba-2 layer, each model position on its
        heads' state; the gated norm combined over ``model``."""
        h = ll.rms_norm(x, lps[0]["ln1"])
        hs = _Broadcast.apply(h, [self.devices[int(p)] for p in row])
        caches = self._states(st, row, rows, layer)
        outs = [mb.mamba_decode_inner(lps[m]["mixer"], caches[m], hs[m],
                                      head_dim=self.cfg.ssm_head_dim) for m in range(self.tp)]
        self._write_states(st, row, rows, layer, [c for *_, c in outs])
        ys = self._gated_norm([y for y, _, _ in outs], [z for _, z, _ in outs],
                              [lp["mixer"]["norm"] for lp in lps])
        return x + self._mixer_out(lps, ys, x[:, 0])[:, None]

    def _rglru_step(self, x, lps, row, rows: slice, st: dict, layer: int, mlp: str):
        """One token through an RG-LRU layer, each model position on its
        channels' state, then its geglu MLP."""
        devices = [self.devices[int(p)] for p in row]
        h = ll.rms_norm(x, lps[0]["ln1"])
        hs = _Broadcast.apply(h, devices)
        caches = self._states(st, row, rows, layer)
        outs = [rg.rglru_decode_inner(lps[m]["mixer"], caches[m], hs[m]) for m in range(self.tp)]
        self._write_states(st, row, rows, layer, [c for _, c in outs])
        x = x + self._mixer_out(lps, [y for y, _ in outs], x[:, 0])[:, None]
        return self._ffn(x, lps, devices, mlp, "geglu")

    def _attend_blocks(self, q: list, kv, layer: int, row, pos: int) -> list:
        """One token's attention over the cache's blocks of slots: each
        owner's ``(position, [B, Hq, D] f32 partial PV)``, combined as
        the module docstring says.  A slot is valid when it holds a
        position up to ``pos``: in order, or in the hybrid family's ring
        of ``ring`` slots one of the last ``ring`` positions (as
        ``models.lm._ring_window_attention`` reads it)."""
        cfg = self.cfg
        d = cfg.head_dim
        group = cfg.num_heads // cfg.num_kv_heads
        owners, spans = kv.owners, kv.spans
        lead = int(row[owners[0]])
        scores, maxima = [], []
        for o in owners:
            p = int(row[o])
            qo = self._collect(q, p, "all-gather")
            b = qo.shape[0]
            qg = qo.reshape(b, cfg.num_kv_heads, group, d).float()
            s = torch.einsum("bhgd,bhkd->bhgk", qg, kv.k.blocks[p][layer].float()) * (1.0 / d**0.5)
            slots = torch.arange(spans[o].start, spans[o].stop, device=self.devices[p])
            if kv.ring is None:
                valid = slots < pos + 1
            else:
                age = (pos % kv.ring - slots) % kv.ring
                valid = pos - age >= max(0, pos - kv.ring + 1)
            s = s.masked_fill(~valid, ll.NEG_INF)
            scores.append(s)
            maxima.append(s.amax(dim=-1))
        top = None  # the max of the blocks' maxima, at the lead owner, then back to each
        for o, mx in zip(owners, maxima):
            mx = self._send(mx, int(row[o]), lead, "all-reduce")
            top = mx if top is None else torch.maximum(top, mx)
        exps, total = [], None  # the sum of exp(s - max), f32, in position order
        for o, s in zip(owners, scores):
            e = torch.exp(s - top.to(s.device)[..., None])
            exps.append(e)
            part = self._send(e.sum(dim=-1), int(row[o]), lead, "all-reduce")
            total = part if total is None else total + part
        del scores
        out = []
        for o, e in zip(owners, exps):
            p = int(row[o])
            vb = kv.v.blocks[p][layer]
            probs = (e / total.to(e.device)[..., None]).to(vb.dtype).float()
            pv = torch.einsum("bhgk,bhkd->bhgd", probs, vb.float())
            out.append((p, pv.reshape(pv.shape[0], cfg.num_heads, d)))
        return out

    def _attn_out(self, pv: list, lps, row, attn: str, x) -> torch.Tensor:
        """The partial PV summed in f32 in position order at the shard's
        first position, cast, through ``wo``: whole, or under ``"heads"``
        each model position's heads through its rows of ``wo``."""
        b, first = x.shape[0], int(row[0])
        out = None
        for p, part in pv:
            part = self._send(part, p, first, "reduce-scatter")
            out = part if out is None else out + part
        if attn != "heads":
            return out.to(x.dtype).reshape(b, 1, self.cfg.q_dim) @ lps[0]["attn"]["wo"]
        heads = self.local.num_heads
        partials = []
        for m in range(self.tp):
            att = self._send(out[:, m * heads:(m + 1) * heads], first, int(row[m]),
                             "reduce-scatter")
            att = att.to(x.dtype).reshape(b, 1, heads * self.cfg.head_dim)
            partials.append(_Partial.apply(att, lps[m]["attn"]["wo"]))
        return _ModelSum.apply(x.device, x.dtype, *partials)


def make_sharded_serve_prefill(cfg: lm.LMConfig, mesh):
    """``(params, batch) -> (logits, cache)`` on ``mesh``: the reference's
    ``make_serve_prefill`` jitted with ``param_shardings`` in and
    ``cache_shardings`` out (see the module docstring)."""
    return ShardedServeStep(cfg, mesh).prefill


def make_sharded_serve_step(cfg: lm.LMConfig, mesh):
    """``(params, cache, batch) -> (logits, cache)`` on ``mesh``: the
    reference's ``make_serve_step`` jitted with ``param_shardings`` and
    ``cache_shardings`` in and out (see the module docstring)."""
    return ShardedServeStep(cfg, mesh).decode
