"""The whole pass's share of the card's f32 peak, %: the configuration's
FLOPs per pass (``2·E·d_in`` to aggregate and ``2·V·k·d_out`` to
transform, each layer) over the traced run's seconds per pass times the
H100's 67 TFLOP/s (float32 outside the tensor cores: these
configurations run f32, TF32 off)."""

from bench.frozen.roofline import H100


def flops_per_pass(ctx) -> float:
    g, cfg = ctx["graph"], ctx["config"]
    widths, k_mult = cfg["widths"], 2 if cfg["model"] == "sage" else 1
    return float(sum(2 * g["num_edges"] * a + 2 * g["num_vertices"] * k_mult * a * b
                     for a, b in zip(widths[:-1], widths[1:])))


def read(ctx):
    w = ctx["window"]
    if not ctx.get("trace") or not w["passes"]:
        return None
    return 100.0 * flops_per_pass(ctx) / (w["seconds"] / w["passes"] * H100["peak_flops_f32"])
