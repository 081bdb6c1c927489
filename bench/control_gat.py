"""The control of ``correct`` in the GAT cells: the plain reference
(``bench/reference/gat.py``) put in the program's place and computed one
precision below the configuration's (float32 with TF32 off -> TF32), read
by the same comparison as a run (``row_err`` against the f64 reference),
on the cell's own inputs at the cell's own size.  Its readings set the
upper end of each limit in ``bench/checks/<cell>.json``; the benchmark's
own runs do not run it.  (``control.py`` is the GCN and SAGE cells'.)

    python3 bench/control_gat.py --workload gat-hbm --seeds 11,12,13 [--precisions tf32,f32]

Prints one JSON line per seed: the compared number of each precision
against the f64 reference.  ``--device cpu`` runs it on the host (TF32 by
rounding, for the tests at small sizes).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, precisions, device: str) -> dict:
    """``{precision: row_err}`` of the GAT reference at each precision
    against the f64 reference, on ``cell``'s inputs for ``seed``."""
    import torch

    from bench import inputs, inputs_gat
    from bench.reference import gat as reference
    from bench.reference.gnn import row_error

    dev = torch.device(device)
    g, _ = inputs.make_graph(cell.traffic["graph"])
    x0, layers = inputs_gat.make_tensors(cell.config, g.num_vertices, seed, dev)
    src, dst = inputs.edge_tensors(g, dev)
    ref = reference.forward(cell.config, src, dst, g.num_vertices, x0, layers, "f64")
    out = {}
    for p in precisions:
        got = reference.forward(cell.config, src, dst, g.num_vertices, x0, layers, p)
        out[p] = row_error(got, ref)
        del got
    return out


def main(argv=None, *, root: Path = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--precisions", default="tf32,f32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from bench.harness import find_cell

    cell = find_cell(root, args.workload, False)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(cell, seed, args.precisions.split(","), args.device)
        print(json.dumps({"cell": cell.name, "seed": seed, "row_err": got,
                          "limit": cell.limits["row_err"]["limit"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
