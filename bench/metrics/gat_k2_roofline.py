"""K2's share of its roofline in a GAT pass, %: the least time for each
layer's projection, ``x [V, d_in] @ [W | W_skip]`` to ``C = H·F``
columns, or ``2·C`` where the layer has a skip (``2·V·d_in·C`` FLOPs at
the f32 peak against ``x``, the weights, the step's zero bias and the
output read or written once, by the frozen ``kernel_cost``/``bound_ms``),
over the device time of K2's kernels in the traced window.  gat-hbm's
shapes: ``[V,128]@[128,1024]``, ``[V,1024]@[1024,2048]``,
``[V,1024]@[1024,1032]``.  ``k2_roofline`` counts GCN's and SAGE's
transforms, ``widths[i] -> widths[i+1]``, and reads GAT's wrong."""

from bench.devtrace import family_seconds
from bench.metrics.k2_roofline import PATTERNS, bound_s


def read(ctx):
    trace, cfg = ctx.get("trace"), ctx["config"]
    if not trace or cfg.get("model") != "gat":
        return None
    seconds = family_seconds(trace, PATTERNS)
    if seconds <= 0:
        return None
    v = ctx["graph"]["num_vertices"]
    need = sum(bound_s(v, d, h * f * (2 if skip else 1))
               for d, h, f, skip in zip(cfg["widths"][:-1], cfg["heads"], cfg["head_dims"],
                                        cfg["skip"]))
    return 100.0 * ctx["window"]["passes"] * need / seconds
