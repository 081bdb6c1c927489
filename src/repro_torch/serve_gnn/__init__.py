"""Out-of-core embedding serving: the read-side counterpart of the ATLAS
inference engine (docs/serving.md).

The engine produces sorted spill files; this package turns them into a
queryable on-disk store without ever materialising the dense [V, d]
matrix:

* ``compact_spills`` / ``GraphStore.publish_servable_layer`` — one-time
  merge into disjoint block-indexed servable files under an immutable
  epoch-numbered version directory,
* ``ServableLayer`` — the opened read view of one version (file + block
  binary search, mmapped id columns),
* ``ShardedPageCache`` — memory-budgeted LRU over decoded blocks,
* ``VertexQueryEngine`` — batched, deduplicating point/batch lookups,
  bit-identical to ``spills_to_dense`` rows.

The lifecycle front door — publish a layer, open a reader pinned to the
version current at open time — is ``repro_torch.session.AtlasSession``
(docs/session_api.md).
"""

from repro_torch.serve_gnn.page_cache import ShardedPageCache
from repro_torch.serve_gnn.query import VertexQueryEngine
from repro_torch.serve_gnn.servable import ServableLayer, compact_spills

__all__ = [
    "ShardedPageCache",
    "VertexQueryEngine",
    "ServableLayer",
    "compact_spills",
]
