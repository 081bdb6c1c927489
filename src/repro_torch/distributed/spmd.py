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
mesh on one card): copies between them are then device-local.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.models import layers as ll
from repro_torch.models import lm
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
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
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
            total = total + p.to(device, torch.float32)
        return total.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *(grad.to(d, t) for d, t in ctx.like))


class _Partial(torch.autograd.Function):
    """``a @ w`` kept in f32 (the product's f32 accumulator, not rounded to
    the operands' dtype): one model position's partial output before the
    sum over ``model``.  Backward in the operands' dtype, as autograd of
    ``a @ w``."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a.is_cuda and a.dtype != torch.float32:
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

    def __init__(self, cfg: lm.LMConfig, opt_cfg: AdamWConfig, mesh, *, timed: bool = False):
        self.cfg, self.opt_cfg, self.mesh, self.timed = cfg, opt_cfg, mesh, timed
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

    # ------------------------------------------------------------ layout
    def _modes(self, seq: int) -> tuple[str, str]:
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

    def _view(self, st: ShardedTensor, target: int, region) -> torch.Tensor:
        out = torch.empty([s.stop - s.start for s in region], dtype=st.dtype,
                          device=self.devices[target])
        for holders in self._owner_map(st).values():
            block = st.placement.block(st.shape, holders[0])
            inter = _intersect(block, region)
            if inter is not None:
                src = st.blocks[self._nearest(holders, target)]
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
        return torch.cat([o.to(h.device) for o in outs], dim=1)

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

    def loss_and_grads(self, params: dict, batch: dict) -> tuple:
        """The global loss (f32, position 0's device) and the gradients: a
        tree like ``params`` of f32 ``ShardedTensor``s on its placements."""
        self.seconds = {}
        cfg = self.cfg
        key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
        seq = batch[key].shape[1]
        attn, mlp = self._modes(seq)
        n_tokens = batch["labels"].numel()
        placements = batch_shardings(self.mesh, batch)
        leaves = tree_paths(params)
        acc = {path: {k: torch.zeros([s.stop - s.start for s in st.placement.block(st.shape, h[0])],
                                     dtype=torch.float32, device=self.devices[h[0]])
                      for k, h in self._owner_map(st).items()}
               for path, st in leaves}
        loss = None
        t = time.perf_counter()
        for i, row in enumerate(self.rows):
            first = int(row[0])
            rows = placements[key].block(tuple(batch[key].shape), first)[0]
            if i and rows == slice(0, batch[key].shape[0]):
                continue  # rows not split: one shard takes them all
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
                ce = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]
                part = ce.sum() / n_tokens
                del h, logits, ce
                grads = torch.autograd.grad(part, [v for *_, v in views])
            part = part.detach().to(self.devices[0])
            loss = part if loss is None else loss + part
            t = self._tick("forward_backward", t)
            for (path, st, region, _), g in zip(views, grads):
                for k, holders in self._owner_map(st).items():
                    block = st.placement.block(st.shape, holders[0])
                    inter = _intersect(block, region)
                    if inter is not None:
                        a = acc[path][k]
                        a[_within(inter, block)] += g[_within(inter, region)].to(a.device,
                                                                                  torch.float32)
            del views, trees, grads
            t = self._tick("reduce", t)
        out = {}
        for path, st in leaves:
            owners = self._owner_map(st)
            blocks = [None] * self.mesh.size
            for k, holders in owners.items():
                for p in holders:
                    blocks[p] = acc[path][k].to(self.devices[p])
            _put(out, path, ShardedTensor(st.placement, st.shape, blocks))
        self._tick("reduce", t)
        return loss, out

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the f32 sum of squares of every distinct gradient block,
        leaves in tree order, blocks in their owners' order."""
        dev0 = self.devices[0]
        total = None
        for _, g in tree_paths(grads):
            for holders in self._owner_map(g).values():
                sq = torch.sum(g.blocks[holders[0]].to(torch.float32).square()).to(dev0)
                total = sq if total is None else total + sq
        return torch.sqrt(total)

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
        per_device = {d: [x.to(d) for x in (scale, k["lr"], k["bc1"], k["bc2"])]
                      for d in set(self.devices)}
        for (_, p), (_, g), (_, m), (_, v) in zip(
                tree_paths(state["params"]), tree_paths(grads), tree_paths(opt["m"]),
                tree_paths(opt["v"])):
            for pos in range(self.mesh.size):
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
