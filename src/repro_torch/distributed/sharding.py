"""Placement rules for the LM zoo on the (pod, data, model) mesh, ported
from ``repro/distributed/sharding.py``.

Megatron-style TP over ``model`` (attention heads / ffn / experts /
vocab), DP over ``pod`` x ``data``, optional FSDP (parameters and
optimizer state split over ``data``, gathered at use).  Rules are
path-based over the parameter tree, so any architecture in the zoo gets a
placement without per-model code.  Every rule degrades gracefully: an axis
is only applied when the dim divides by the mesh axis size.

A placement is what the reference's ``NamedSharding`` is: a mesh (the
port's ``dist.mesh.Mesh``: a shape, axis names and one device name per
position) and a spec with one entry per leading dimension, each an axis
name, a tuple of names or ``None``, as a ``PartitionSpec``'s entries.  A
``ShardedTensor`` holds one block per mesh position, each on that
position's device: where the spec leaves an axis out, the positions along
it hold copies of the same block.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.dist.mesh import Mesh


def dp_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fit(mesh: Mesh, dim: int, axes):
    """axes if dim divides evenly over them, else None (replicate)."""
    return axes if axes and dim % axis_size(mesh, axes) == 0 else None


def _leaf_spec(path: str, shape: tuple, mesh: Mesh, fsdp) -> tuple:
    """The spec of one parameter leaf.  ``path`` is '/'-joined key names;
    stacked block parameters carry a leading layer axis (never split)."""
    def spec(*axes):
        return tuple(_fit(mesh, d, a) for d, a in zip(shape, axes))

    stacked = any(
        k in path for k in ("blocks/", "moe_blocks/", "dense_blocks/", "super/", "tail/")
    )
    L = (None,) if stacked else ()
    name = path.rsplit("/", 1)[-1]

    # ---- top-level ------------------------------------------------------
    if name == "embed":
        return spec(None, "model")
    if name == "lm_head":
        return spec(fsdp, "model")
    if name == "final_norm":
        return ()

    # ---- norms / small vectors -----------------------------------------
    if name in ("ln1", "ln2", "q_norm", "k_norm", "lam", "a_log", "d_skip",
                "dt_bias", "down_b"):
        return L + (None,) * (len(shape) - len(L))
    if name == "norm":  # mamba gated-norm over d_inner (head-sharded)
        return spec(*L, "model")

    # ---- attention -------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return spec(*L, fsdp, "model")
    if name == "wo" and "mixer" not in path:
        return spec(*L, "model", fsdp)
    if name in ("bq", "bk", "bv", "up_b"):
        return spec(*L, "model")

    # ---- MLP --------------------------------------------------------------
    if name in ("gate", "up") and "moe/" not in path:
        return spec(*L, fsdp, "model")
    if name == "down" and "moe/" not in path:
        return spec(*L, "model", fsdp)

    # ---- MoE (experts split over `model` = EP) ----------------------------
    if "moe/" in path:
        if name == "router":
            return L + (None,) * (len(shape) - len(L))
        if name in ("gate", "up"):
            return spec(*L, "model", fsdp, None)
        if name == "down":
            return spec(*L, "model", None, fsdp)

    # ---- Mamba-2 (head-parallel TP) ---------------------------------------
    if name in ("wz", "wx", "wdt"):
        return spec(*L, fsdp, "model")
    if name in ("wb", "wc"):
        return spec(*L, fsdp, None)
    if name == "conv_x":
        return spec(*L, None, "model")
    if name == "wo":  # mamba/rglru out-projection
        return spec(*L, "model", fsdp)

    # ---- RG-LRU -----------------------------------------------------------
    if name in ("in1", "in2"):
        return spec(*L, fsdp, "model")
    if name == "conv":
        return spec(*L, None, "model")
    if name in ("w_r", "w_i"):  # block-diagonal gates: blocks over model
        return spec(*L, "model", None, None)

    return ()  # safe default: replicate


# --------------------------------------------------------------------------
# trees (dicts of leaves, keys in sorted order, as jax flattens dicts)
# --------------------------------------------------------------------------


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) in sorted key order, paths '/'-joined."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], dict):
            out += tree_paths(tree[key], path)
        else:
            out.append((path, tree[key]))
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _with_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


# --------------------------------------------------------------------------
# placements and sharded tensors
# --------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@functools.lru_cache(maxsize=None)
def _coords_table(shape: tuple) -> tuple:
    """Every position's coordinates on a mesh of ``shape``, row-major."""
    return tuple(tuple(int(c) for c in np.unravel_index(p, shape))
                 for p in range(math.prod(shape)))


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple = ()

    def coords(self, pos: int) -> dict[str, int]:
        return dict(zip(self.mesh.axis_names, _coords_table(self.mesh.shape)[pos]))

    def _entries(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than {ndim} dims")
        return [_entry_axes(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def key(self, shape: tuple, pos: int) -> tuple[int, ...]:
        """The block index along each dim held at position ``pos``."""
        c, sizes = self.coords(pos), _sizes(self.mesh)
        out = []
        for axes in self._entries(len(shape)):
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + c[a]
            out.append(idx)
        return tuple(out)

    def block(self, shape: tuple, pos: int) -> tuple[slice, ...]:
        """The region of a ``shape`` leaf held at position ``pos``."""
        out = []
        for n, axes, idx in zip(shape, self._entries(len(shape)), self.key(shape, pos)):
            parts = axis_size(self.mesh, axes)
            if n % parts:
                raise ValueError(f"dim {n} does not divide over {axes} ({parts} parts)")
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def owners(self, shape: tuple) -> dict[tuple[int, ...], list[int]]:
        """Each distinct block's key -> the positions that hold it, in
        position order (the first is its owner)."""
        out: dict[tuple[int, ...], list[int]] = {}
        for pos in range(self.mesh.size):
            out.setdefault(self.key(shape, pos), []).append(pos)
        return out


def position_devices(mesh: Mesh) -> list[torch.device]:
    """The torch device of every position, in position order."""
    grid, rows = mesh.torch_devices(), mesh.positions()
    out: list[torch.device] = [None] * mesh.size  # type: ignore[list-item]
    for i, row in enumerate(rows):
        for m, pos in enumerate(row):
            out[pos] = grid[i][m]
    return out


def _fresh(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that aliases nothing."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


@dataclasses.dataclass
class ShardedTensor:
    """One block per mesh position (``blocks[pos]`` on that position's
    device) of a ``shape`` leaf placed by ``placement``."""

    placement: Placement
    shape: tuple
    blocks: list

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (default position 0's), each
        distinct block copied once from its owner."""
        device = self.blocks[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for key, holders in self.placement.owners(self.shape).items():
            out[self.placement.block(self.shape, holders[0])] = self.blocks[holders[0]]
        return out


def shard(t: torch.Tensor, placement: Placement, devices=None) -> ShardedTensor:
    """``t``'s block for every position of the placement's mesh, each a
    fresh copy on its position's device."""
    devices = position_devices(placement.mesh) if devices is None else devices
    shape = tuple(t.shape)
    return ShardedTensor(placement, shape, [_fresh(t[placement.block(shape, p)], devices[p])
                                            for p in range(placement.mesh.size)])


def from_blocks(placement: Placement, shape: tuple, load, devices=None) -> ShardedTensor:
    """A sharded leaf whose distinct blocks come from ``load(region)`` (a
    tensor of that region of the leaf), each loaded once, put on its
    owner's device and copied to the positions that hold it too."""
    devices = position_devices(placement.mesh) if devices is None else devices
    shape = tuple(shape)
    blocks = [None] * placement.mesh.size
    for key, holders in placement.owners(shape).items():
        first = load(placement.block(shape, holders[0])).to(devices[holders[0]])
        for p in holders:
            blocks[p] = _fresh(first, devices[p])
    return ShardedTensor(placement, shape, blocks)


def shard_tree(tree, placements, devices=None):
    """``shard`` over a tree of tensors and a matching tree of placements."""
    return tree_map(lambda t, pl: shard(t, pl, devices), tree, placements)


def unshard_tree(tree, device=None):
    """Each ``ShardedTensor`` leaf of ``tree`` as its whole tensor."""
    return tree_map(lambda t: t.full(device) if isinstance(t, ShardedTensor) else t, tree)


# --------------------------------------------------------------------------
# the reference's entry points
# --------------------------------------------------------------------------


def param_shardings(mesh: Mesh, params_shape, fsdp: bool = True):
    """A ``Placement`` tree matching ``params_shape`` (leaves with a
    ``.shape``)."""
    fsdp_ax = "data" if (fsdp and "data" in mesh.axis_names) else None
    return _with_paths(
        lambda path, v: Placement(mesh, _leaf_spec(path, tuple(v.shape), mesh, fsdp_ax)),
        params_shape,
    )


def batch_shardings(mesh: Mesh, batch_shape):
    """Rows over the data-parallel axes where they divide, else replicated."""
    dp = dp_axes(mesh)

    def one(v):
        if not v.ndim:
            return Placement(mesh, ())
        ax = dp if v.shape[0] % axis_size(mesh, dp) == 0 else None
        return Placement(mesh, (ax,) + (None,) * (v.ndim - 1))

    return tree_map(one, batch_shape)


def cache_shardings(mesh: Mesh, cache_shape):
    """Decode-cache rules: batch over DP axes; the KV cache's sequence dim
    over ``model`` (flash-decoding layout: attention reads stay local,
    only softmax statistics and the small output cross positions); SSM
    heads and RG-LRU channels over ``model``.  A non-tensor leaf (the
    port's ``length`` is a Python int) is replicated."""
    dp = dp_axes(mesh)

    def one(path, v):
        name = path.rsplit("/", 1)[-1]
        if name == "length" or not getattr(v, "ndim", 0):
            return Placement(mesh, ())
        dims = list(v.shape)
        spec: list = [None] * v.ndim
        if name in ("k", "v"):  # [L, B, Hkv, S, Dh]
            spec[1] = _fit(mesh, dims[1], dp)
            spec[3] = _fit(mesh, dims[3], "model")
        elif name == "ssm":  # [L, B, H, P, N]
            spec[1] = _fit(mesh, dims[1], dp)
            spec[2] = _fit(mesh, dims[2], "model")
        elif name == "conv":  # [L, B, W, C]
            spec[1] = _fit(mesh, dims[1], dp)
            spec[3] = _fit(mesh, dims[3], "model")
        elif name == "h":  # [L, B, R]
            spec[1] = _fit(mesh, dims[1], dp)
            spec[2] = _fit(mesh, dims[2], "model")
        else:
            spec[0] = _fit(mesh, dims[0], dp)
        return Placement(mesh, tuple(spec))

    return _with_paths(one, cache_shape)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())
