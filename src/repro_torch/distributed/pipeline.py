"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis,
ported from ``repro/distributed/pipeline.py``.

Each stage owns L/n_stages consecutive layers (the stacked parameters'
leading axis, split over the stage axis) on its position's device; the
microbatches enter stage 0 one a tick and hop stage to stage as device
copies, so at tick ``t`` stage ``s`` runs microbatch ``t - s``: the classic
schedule of ``M + n - 1`` ticks with its ``n - 1``-tick bubble.  The last
stage's outputs are the result.  Gradients come from autograd through the
copies (the reference gets them from ``ppermute``'s transpose).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.mesh import Mesh
from repro_torch.distributed.sharding import position_devices, tree_map


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _layers(stacked, lo: int, hi: int, device) -> list:
    """Layers [lo, hi) of a stacked tree as per-layer trees on ``device``."""
    local = tree_map(lambda t: t[lo:hi].to(device), stacked)
    return [tree_map(lambda t, j=j: t[j], local) for j in range(hi - lo)]


def make_pipeline_forward(mesh: Mesh, stage_axis: str, layer_fn):
    """Returns ``fn(stacked_params, x)``:

      stacked_params: [L, ...] tree of tensors, L divisible by n_stages
      x:              [M, mb, ...] microbatched input
      returns:        [M, mb, ...] output of the full L-layer stack, on
                      x's device

    ``layer_fn(layer_params, h) -> h`` is one layer.  Stage ``s`` runs on
    the position at coordinate ``s`` of ``stage_axis`` (0 on the others).
    """
    axis = mesh.axis_names.index(stage_axis)
    n_stages = mesh.shape[axis]
    devices = position_devices(mesh)
    stage_dev = [devices[int(np.ravel_multi_index(
        tuple(s if a == axis else 0 for a in range(len(mesh.shape))), mesh.shape))]
        for s in range(n_stages)]

    def fn(stacked_params, x):
        depth = _depth(stacked_params)
        if depth % n_stages:
            raise ValueError(f"{depth} layers do not divide over {n_stages} stages")
        per = depth // n_stages
        stages = [_layers(stacked_params, s * per, (s + 1) * per, stage_dev[s])
                  for s in range(n_stages)]
        m = x.shape[0]
        recv: list = [None] * n_stages
        out: list = [None] * m
        for t in range(m + n_stages - 1):
            sent: list = [None] * n_stages
            for s in range(n_stages):
                j = t - s
                if not 0 <= j < m:
                    continue
                h = x[j].to(stage_dev[0]) if s == 0 else recv[s]
                for lp in stages[s]:
                    h = layer_fn(lp, h)
                if s == n_stages - 1:
                    out[j] = h.to(x.device)
                else:
                    sent[s + 1] = h.to(stage_dev[s + 1])
            recv = sent
        return torch.stack(out)

    return fn


def sequential_forward(stacked_params, x, layer_fn):
    """Oracle: the same stack without pipelining, each layer applied to
    each microbatch in turn (the reference's ``vmap``). x [M, mb, ...]."""
    depth = _depth(stacked_params)
    for lp in _layers(stacked_params, 0, depth, x.device):
        x = torch.stack([layer_fn(lp, h) for h in x])
    return x
