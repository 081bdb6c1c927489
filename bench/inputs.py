"""A run's inputs: the traffic's graph on the host with the frozen
generators, from the traffic's own seed (the graph is the deployment's
dataset: every run's work has the same sizes), kept in the checkout's
``build/bench/graphs`` after its first run, and the features and
every layer's weights from the run's seed, on the device with one
``torch.Generator``, in a few large calls, in float32.

The initialisation follows the program's (``init_gnn_params``,
``make_features`` in ``src/repro_torch``, commit
4cdb0a73912ceae5e46a51aa52d89d73ba4acce5): features standard normal over
sqrt(d), Glorot-uniform weights ``[fan_in, d_out]`` (a SAGE layer's
``fan_in`` is ``2·d_in``, self rows first).  Two departures: the draws
come from the device's generator, and the bias is drawn uniform in
``±bias_scale`` (the configuration's ``assumed``) instead of zero, so
that the check covers it.  Both sides of a run, program and reference,
get these same tensors.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import zipfile
from pathlib import Path

import numpy as np
import torch

from bench.frozen.synth import GENERATORS, Graph

# Part of every cached graph's key: a change to the frozen generators
# takes a new tag, so that no checkout reads a graph they no longer make.
GENERATORS_TAG = "synth@4cdb0a73912ceae5e46a51aa52d89d73ba4acce5"


def seed64(seed: int) -> int:
    """The run's seed as a generator seed (any whole number)."""
    return int(seed) % (1 << 63)


def make_graph(spec: dict, cache_dir: Path | None = None) -> tuple[Graph, bool]:
    """``(graph, cached)``: the traffic's graph, where ``spec`` names the
    ``generator`` and its parameters (``num_vertices``, ``avg_degree``,
    ``seed``, ...).  With ``cache_dir`` the CSR is kept there under a name
    made from ``spec``, so only a checkout's first run generates it."""
    path = None
    if cache_dir is not None:
        key = json.dumps({"spec": spec, "generators": GENERATORS_TAG}, sort_keys=True)
        path = Path(cache_dir) / "graphs" / f"{hashlib.sha256(key.encode()).hexdigest()[:24]}.npz"
        if path.is_file():
            try:
                with np.load(path) as f:
                    g = Graph(indptr=f["indptr"], indices=f["indices"])
                if g.num_vertices == spec["num_vertices"] and g.num_edges == len(g.indices):
                    return g, True
            except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
                pass  # a partial or foreign file: generate anew
    params = {k: v for k, v in spec.items() if k != "generator"}
    g = GENERATORS[spec["generator"]](**params)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_name(f"{path.stem}.{os.getpid()}.part.npz")
        np.savez(part, indptr=g.indptr, indices=g.indices)
        os.replace(part, path)
    return g, False


def fan_in(model: str, d_in: int) -> int:
    return 2 * d_in if model == "sage" else d_in


def make_tensors(config: dict, num_vertices: int, seed: int, device) -> tuple:
    """``(x, layers)``: features ``[V, widths[0]]`` and ``(w, b)`` per
    layer, float32 on ``device``."""
    widths, model = config["widths"], config["model"]
    bias_scale = float(config["assumed"]["bias_scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    x = torch.randn(num_vertices, widths[0], generator=gen, device=device)
    x.mul_(1.0 / math.sqrt(widths[0]))
    shapes = [(fan_in(model, a), b) for a, b in zip(widths[:-1], widths[1:])]
    sizes = [k * m + m for k, m in shapes]
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    layers = []
    for (k, m), part in zip(shapes, torch.split(u, sizes)):
        w = part[: k * m].view(k, m) * math.sqrt(6.0 / (k + m))
        b = part[k * m:] * bias_scale
        layers.append((w.contiguous(), b.contiguous()))
    return x, layers


def edge_tensors(graph: Graph, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)`` int64 on ``device``: the reference's view of the graph."""
    src, dst = graph.edges()
    return (torch.from_numpy(np.ascontiguousarray(src)).to(device),
            torch.from_numpy(np.ascontiguousarray(dst)).to(device))
