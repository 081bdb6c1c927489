"""The sharded train step: the port's counterpart of the reference's
``jax.jit(make_train_step(cfg, opt_cfg), in_shardings=(state, batch))``
over a (data, model) or (pod, data, model) mesh (``repro/launch/train.py``).

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
     by sequence).  For the attention-and-MLP families, where
     ``attention_split`` says ``"heads"``, position ``m`` runs its heads
     (K3 at ``Hq/tp``, ``Hkv/tp``) with its columns of ``wq/wk/wv/bq/bk/bv``
     and its rows of ``wo``, and its columns of ``gate/up`` and rows of
     ``down``; the partial outputs of ``wo`` and ``down`` are summed over
     ``model`` in f32, in position order, then cast.  Where it says
     ``"sequence"``, position ``m`` runs its block of query rows against
     the keys and values before them (K3 on the rows up to its block, its
     own rows taken), and the blocks are concatenated.  The other
     families run whole at ``(i, 0)``.  The shard's loss is its tokens'
     cross-entropy sum over the global token count, so the shards' losses
     sum to the global mean;
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
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.annotate import attention_split
from repro_torch.distributed.sharding import (
    ShardedTensor,
    batch_shardings,
    param_shardings,
    position_devices,
    replicated,
    shard_tree,
    tree_paths,
)
from repro_torch.kernels._build import CARD_TYPES
from repro_torch.models import layers as ll
from repro_torch.models import lm
from repro_torch.perf import hlo_cost
from repro_torch.train.optimizer import AdamWConfig, adamw_leaf, clip_scale, step_scalars

_SPLIT_FAMILIES = ("dense", "audio", "vlm")  # attention + MLP blocks


def state_shardings(mesh, state) -> dict:
    """Placements of a train state: the parameters' and both moments' by
    ``param_shardings`` (FSDP over ``data``), ``step`` replicated."""
    psh = param_shardings(mesh, state["params"])
    return {"params": psh, "opt": {"m": psh, "v": psh, "step": replicated(mesh)}}


def shard_train_state(state, mesh) -> dict:
    """A one-device train state split onto ``mesh``: every position's
    blocks copied to its device."""
    return shard_tree(state, state_shardings(mesh, state))


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


def _put(tree: dict, path: str, value) -> None:
    """``value`` at the '/'-joined ``path`` of a nested dict."""
    *parents, name = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[name] = value


def _sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


class ShardedTrainStep:
    """``step(state, batch) -> (state, metrics)`` on a sharded state
    (``shard_train_state``), updated in place; ``metrics`` hold ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim f32 tensors on position 0's device.

    ``loss_and_grads`` and ``apply`` are the step's two halves; ``apply``
    takes an explicit clip ``scale`` too.  With ``timed``, ``seconds``
    holds the last step's seconds of gather, forward_backward, reduce and
    optimizer (host clock, the devices synchronized at each boundary)."""

    def __init__(self, cfg: lm.LMConfig, opt_cfg: AdamWConfig, mesh, *, timed: bool = False,
                 plan: bool = False):
        self.cfg, self.opt_cfg, self.mesh, self.timed = cfg, opt_cfg, mesh, timed
        self.plan = plan
        self.devices = position_devices(mesh)
        self.rows = mesh.positions()  # [data shard, model position] -> position
        self.tp = mesh.model_size
        self._coords = [tuple(int(c) for c in np.unravel_index(p, mesh.shape))
                        for p in range(mesh.size)]
        self.tensor_parallel = cfg.family in _SPLIT_FAMILIES and self.tp > 1
        self.attention = (attention_split(cfg.num_heads, cfg.num_kv_heads, self.tp)
                          if self.tensor_parallel else "whole")
        self.mlp = "columns" if self.tensor_parallel and cfg.d_ff % self.tp == 0 else "whole"
        self.local = cfg
        if self.attention == "heads":
            self.local = dataclasses.replace(
                cfg, num_heads=cfg.num_heads // self.tp, num_kv_heads=cfg.num_kv_heads // self.tp,
                d_ff=cfg.d_ff // self.tp)
        self.seconds: dict[str, float] = {}
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
        whose 1/tp share each takes (None: the whole leaf)."""
        every = list(range(self.tp))
        name = path.rsplit("/", 1)[-1]
        if "/attn/" in path and attn != "whole":
            if name in ("q_norm", "k_norm") or attn == "sequence":
                return every, None
            return every, (-2 if name == "wo" else -1)
        if "/mlp/" in path and mlp == "columns" and name != "down_b":
            return every, (-2 if name == "down" else -1)
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

    def _view(self, st: ShardedTensor, target: int, region) -> torch.Tensor:
        out = torch.empty([s.stop - s.start for s in region], dtype=st.dtype,
                          device=self.devices[target])
        for run in self._runs(self._pieces(st, region), region):
            _, holders, block, inter = run[0][:4]
            src = st.blocks[self._nearest(holders, target)]
            with hlo_cost.repeat(len(run)):
                out[_within(inter, region)].copy_(src[_within(inter, block)])
        return out

    # ----------------------------------------------------------- forward
    def _attn(self, lps, h, positions, attn: str):
        p0 = lps[0]["attn"]
        if attn == "whole":
            return lm._attend(p0, self.cfg, h, positions[0])[0] @ p0["wo"]
        hs = _Broadcast.apply(h, [positions[m].device for m in range(self.tp)])
        if attn == "heads":
            outs = [_Partial.apply(lm._attend(lps[m]["attn"], self.local, hs[m], positions[m])[0],
                                   lps[m]["attn"]["wo"]) for m in range(self.tp)]
            return _ModelSum.apply(h.device, h.dtype, *outs)
        outs = [self._attn_rows(lps[m]["attn"], hs[m], positions[m], m) for m in range(self.tp)]
        return torch.cat([outs[0]] + [_Move.apply(o, h.device, "all-gather", "reduce-scatter")
                                      for o in outs[1:]], dim=1)

    def _attn_rows(self, p, h, positions, m: int):
        """Model position ``m``'s block of query rows (``"sequence"``): K3 on
        the rows up to the end of the block, the earlier query rows zero,
        the block's rows of the output taken."""
        cfg = self.cfg
        b, s, _ = h.shape
        w = s // self.tp
        lo, hi = m * w, (m + 1) * w
        q = ll.apply_rope(lm._heads(p, cfg, h[:, lo:hi], "q", cfg.num_heads),
                          positions[lo:hi], cfg.rope_theta)
        k = ll.apply_rope(lm._heads(p, cfg, h[:, :hi], "k", cfg.num_kv_heads),
                          positions[:hi], cfg.rope_theta)
        v = lm._heads(p, cfg, h[:, :hi], "v", cfg.num_kv_heads)
        att = ll.blockwise_attention(F.pad(q, (0, 0, lo, 0)), k, v, causal=True)[:, :, lo:]
        return att.transpose(1, 2).reshape(b, w, cfg.q_dim) @ p["wo"]

    def _mlp(self, lps, h, positions, mlp: str):
        p0, kind = lps[0]["mlp"], self.cfg.mlp_kind
        if mlp == "whole":
            return ll.mlp_forward(p0, h, kind)
        hs = _Broadcast.apply(h, [positions[m].device for m in range(self.tp)])
        outs = [_Partial.apply(ll.mlp_hidden(lps[m]["mlp"], hs[m], kind), lps[m]["mlp"]["down"])
                for m in range(self.tp)]
        y = _ModelSum.apply(h.device, h.dtype, *outs)  # the bias once, after the sum
        return y + p0["down_b"] if "down_b" in p0 else y

    def _block(self, x, lps, positions, attn: str, mlp: str):
        p0 = lps[0]
        x = x + self._attn(lps, ll.rms_norm(x, p0["ln1"]), positions, attn)
        return x + self._mlp(lps, ll.rms_norm(x, p0["ln2"]), positions, mlp)

    def _hidden(self, trees: list[dict], inputs, positions, attn: str, mlp: str):
        cfg = self.cfg
        if not self.tensor_parallel:
            return lm.forward_hidden(trees[0], cfg, inputs, positions[0])
        x = lm._embed(trees[0], cfg, inputs)
        depth = lm._depth(trees[0]["blocks"])
        layers = [lm._unstack(t["blocks"], depth) for t in trees]
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in range(depth):
            lps = [layers[m][layer] for m in range(len(trees))]
            if remat:
                x = torch.utils.checkpoint.checkpoint(self._block, x, lps, positions, attn, mlp,
                                                      use_reentrant=False)
            else:
                x = self._block(x, lps, positions, attn, mlp)
        return ll.rms_norm(x, trees[0]["final_norm"])

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

    def _note_shard_copies(self, i: int, leaves, attn: str, mlp: str) -> None:
        """Data shard ``i``'s copies between distinct positions: the gather
        of its views' blocks from their nearest holders, the reduce of its
        views' gradients to the blocks' owners, its loss to position 0."""
        row = self.rows[i]
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
                    if holders[0] != target:
                        moved["reduce-scatter"][0] += n * item
                        moved["reduce-scatter"][1] += 1
        for kind, (nbytes, count) in moved.items():
            if count:
                hlo_cost.note_copy(kind, nbytes, count)
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
        placements = batch_shardings(self.mesh, batch)
        whole = tuple(batch[key].shape)

        def rows_of(pos: int) -> slice:  # -1: the whole batch
            return slice(0, whole[0]) if pos < 0 else placements[key].block(whole, pos)[0]

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
