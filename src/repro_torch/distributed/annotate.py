"""Activation-placement annotations for model code, ported from
``repro/distributed/annotate.py``.

Model definitions stay mesh-agnostic: they call ``constrain(x, ...)``
with *logical* axis names, resolved against an ambient mesh set by the
launcher.  With no mesh set (unit tests, one device) everything is a
no-op, as in the reference.

The reference's constraints steer GSPMD.  The port has no partitioner:
its tensors carry no placement, and the sharded train step
(``distributed/spmd.py``) splits the work itself.  So here, with a mesh
set, ``constrain`` checks the annotation (its rank) and returns ``x``
unchanged, ``placement`` gives the spec the reference would resolve, and
the choice between the two attention layouts is the plain function
``attention_split``, which the sharded step reads:

  * head-parallel attention when heads % tp == 0 for q and kv (Megatron),
  * else sequence-parallel queries and replicated KV (Ulysses-style
    context parallelism), head-count agnostic.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import axis_size

_MESH = None


def set_annotation_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_annotation_mesh():
    return _MESH


def _resolve(mesh, logical, dim: int):
    if logical is None:
        return None
    if logical == "dp":
        ax = tuple(a for a in mesh.axis_names if a != "model")
        ax = ax if len(ax) > 1 else (ax[0] if ax else None)
    elif logical in ("tp", "sp", "model"):
        ax = "model" if "model" in mesh.axis_names else None
    else:
        ax = logical if logical in mesh.axis_names else None
    if ax is None or dim % axis_size(mesh, ax) != 0:
        return None
    return ax


def _tp(mesh) -> int:
    return axis_size(mesh, "model") if "model" in mesh.axis_names else 1


def attention_split(hq: int, hkv: int, tp: int) -> str:
    """``"heads"`` when both head counts divide the TP degree, else
    ``"sequence"`` (queries split by sequence, keys and values whole)."""
    return "heads" if hq % tp == 0 and hkv % tp == 0 else "sequence"


def placement(mesh, shape: tuple, *logical) -> tuple:
    """The spec the reference's ``constrain`` resolves ``logical`` to for
    a ``shape`` tensor on ``mesh``."""
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical axes for a rank-{len(shape)} tensor")
    return tuple(_resolve(mesh, lg, d) for lg, d in zip(logical, shape))


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """No-op without a mesh; with one, checks the annotation's rank."""
    if _MESH is not None:
        placement(_MESH, tuple(x.shape), *logical)
    return x


def constrain_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Attention inputs [B, H, S, D]: head-parallel when divisible, else
    sequence-parallel q and replicated kv."""
    if _MESH is None:
        return q, k, v
    if attention_split(q.shape[1], k.shape[1], _tp(_MESH)) == "heads":
        return tuple(constrain(t, "dp", "tp", None, None) for t in (q, k, v))
    return (constrain(q, "dp", None, "sp", None), constrain(k, "dp", None, None, None),
            constrain(v, "dp", None, None, None))


def constrain_attn_out(att: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """Attention output [B, H, S, D]: mirrors ``constrain_qkv``'s choice."""
    if _MESH is None:
        return att
    if attention_split(att.shape[1], num_kv_heads, _tp(_MESH)) == "heads":
        return constrain(att, "dp", "tp", None, None)
    return constrain(att, "dp", None, "sp", None)
