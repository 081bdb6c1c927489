"""Shard-parallel out-of-core inference on the session API.

The paper's broadcast model distributes along its natural seam: range-
partition the internal vertex ID space into N contiguous shards, let each
shard stream *its own source range* once per layer (the same sequential
single-pass the single-machine reader does) and push messages — local
destinations straight into the shard's hot store, remote destinations
through a per-layer (src_shard, dst_shard) bucket exchange.  Shard-local
spills flow through per-shard ``WritebackIOScheduler``s; the coordinator
advances one run manifest only after an all-shard layer barrier, and
publishes merge into one versioned store so an unmodified
``session.reader`` serves the result by external ID.

Entry points:

* ``DistSession`` — the facade (``shards=N``, ``exchange="local"|"mesh"``,
  ``workers="thread"|"process"``, ``mesh_devices``); see
  ``repro_torch.dist.session``.
* ``repro_torch.launch.infer_dist`` — the CLI launcher (and the per-shard
  worker subprocess entry point for ``workers="process"``).

Each shard runs chunk aggregation (K1) and the graduation transform (K2)
on the device ``AtlasConfig.backend`` names.  On exact-arithmetic graphs
(power-of-two degrees, small-integer features/weights) any shard count
produces spills and served rows bitwise identical to the single-machine
engine — enforced by ``tests/test_torch_dist.py`` against the JAX
package's ``DistSession``.
"""

from repro_torch.dist.partition import ShardPlan
from repro_torch.dist.session import (
    DistRunManifest,
    DistSession,
    DistWorkerError,
)

__all__ = [
    "DistRunManifest",
    "DistSession",
    "DistWorkerError",
    "ShardPlan",
]
