"""K2's share of its roofline, %: the least time for each layer's
transform, ``2·V·k·m`` FLOPs (``k = d_in``, or ``2·d_in`` with SAGE's
self term) at the f32 peak against ``x``, ``W``, ``b`` read and the
output written once, by the frozen ``kernel_cost``/``bound_ms``, over the
device time of K2's kernels in the traced window."""

from bench.devtrace import family_seconds
from bench.frozen.roofline import bound_ms, kernel_cost

PATTERNS = ("sgemm_kernel", "graduate_tc_kernel")  # csrc/fused_graduate.cu


def bound_s(v: int, k: int, m: int) -> float:
    cost = kernel_cost("fused_graduate", [((v, k), "float32"), ((k, m), "float32"),
                                          ((m,), "float32"), ((v, m), "float32")])
    return bound_ms(cost)[0] / 1e3


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    seconds = family_seconds(trace, PATTERNS)
    if seconds <= 0:
        return None
    v, cfg = ctx["graph"]["num_vertices"], ctx["config"]
    widths, self_term = cfg["widths"], cfg["model"] == "sage"
    need = sum(bound_s(v, (2 if self_term else 1) * a, b) for a, b in zip(widths[:-1], widths[1:]))
    return 100.0 * ctx["window"]["passes"] * need / seconds
