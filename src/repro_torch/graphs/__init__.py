from repro_torch.graphs.csr import CSRGraph, build_csr, build_csc, degrees_from_csr
from repro_torch.graphs.synth import powerlaw_graph, uniform_graph, make_features
from repro_torch.graphs.partition import RangePartition

__all__ = [
    "CSRGraph",
    "build_csr",
    "build_csc",
    "degrees_from_csr",
    "powerlaw_graph",
    "uniform_graph",
    "make_features",
    "RangePartition",
]
