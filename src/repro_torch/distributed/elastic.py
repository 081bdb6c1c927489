"""Elastic scaling: re-factorise the mesh for a new device count and
reshard a checkpointed train state onto it, ported from
``repro/distributed/elastic.py``.

Node failures at 1000+-node scale shrink the healthy device pool; rather
than waiting for replacements, the job restarts on the survivors:

  1. ``remesh_factors(n)`` picks the new (data, model) factorisation,
     keeping the model-parallel degree where it divides (the TP degree is
     set by per-chip memory, not by the device count) and folding the loss
     into the data axis;
  2. ``CheckpointManager.restore(..., shardings=state_shardings(new_mesh,
     like))`` puts every leaf straight into its blocks on the new mesh, with
     no resharding pass.

``launch/elastic_check.py`` trains on a (4, 2) mesh, checkpoints, and
resumes on (2, 2).
"""

from __future__ import annotations

from repro_torch.distributed.sharding import ShardedTensor, shard, tree_map
from repro_torch.launch.mesh import make_mesh


def remesh_factors(n_devices: int, model_parallel: int = None,
                   multi_pod: bool = False) -> tuple:
    """Choose a mesh shape for ``n_devices``."""
    if model_parallel is None:
        # largest power-of-two TP degree <= sqrt(n)
        model_parallel = 1
        while model_parallel * 2 * model_parallel * 2 <= n_devices:
            model_parallel *= 2
    while n_devices % model_parallel:
        model_parallel //= 2
    data = n_devices // model_parallel
    if multi_pod and data % 2 == 0:
        return (2, data // 2, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def elastic_mesh(n_devices: int, model_parallel: int = None, multi_pod: bool = False,
                 devices=None):
    """The mesh ``remesh_factors`` picks, over ``devices`` (one name per
    position, a single name repeated, or None for ``cuda:0 .. cuda:n-1``)."""
    shape, axes = remesh_factors(n_devices, model_parallel, multi_pod)
    return make_mesh(shape, axes, devices)


def reshard(tree, shardings):
    """Each leaf of ``tree`` (a tensor or a ``ShardedTensor`` on any mesh)
    moved onto the matching placement of ``shardings``, through its whole
    value on its first block's device."""
    def one(t, placement):
        return shard(t.full() if isinstance(t, ShardedTensor) else t, placement)

    return tree_map(one, tree, shardings)
