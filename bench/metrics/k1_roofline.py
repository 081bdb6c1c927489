"""K1's share of its roofline, %: the least time the card needs for the
aggregation these inputs need, each byte once (features ``[V, d]`` read,
``E`` source indices and weights, ``V + 1`` offsets, ``[V, d]`` f32
written; 2·E·d FLOPs at the f32 peak), per layer by the frozen
``kernel_cost``/``bound_ms``, over the device time of K1's kernels in
the traced window."""

from bench.devtrace import family_seconds
from bench.frozen.roofline import bound_ms, kernel_cost

PATTERNS = ("segment_rows_kernel", "segment_reduce_kernel")  # csrc/edge_block_spmm.cu


def bound_s(v: int, e: int, d: int) -> float:
    cost = kernel_cost("edge_block_spmm", [((v, d), "float32"), ((e,), "int32"),
                                           ((e,), "float32"), ((v + 1,), "int32"),
                                           ((v, d), "float32")])
    return bound_ms(cost)[0] / 1e3


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    seconds = family_seconds(trace, PATTERNS)
    if seconds <= 0:
        return None
    g, widths = ctx["graph"], ctx["config"]["widths"]
    need = sum(bound_s(g["num_vertices"], g["num_edges"], d) for d in widths[:-1])
    return 100.0 * ctx["window"]["passes"] * need / seconds
