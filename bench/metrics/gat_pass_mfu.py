"""The whole GAT pass's share of the card's f32 peak, %: GAT's FLOPs per
pass over the traced run's seconds per pass times the H100's 67 TFLOP/s
(float32 outside the tensor cores: the configuration runs f32, TF32 off).

Per layer of H heads of F (``HF = H·F``) from ``d_in`` over V vertices
and E edges: the projection ``2·V·d_in·HF`` (twice with the skip), the
scores ``4·V·HF`` (two dots a head), and the attention-weighted sums
``2·E·HF``."""

from bench.frozen.roofline import H100


def flops_per_pass(ctx) -> float:
    g, cfg = ctx["graph"], ctx["config"]
    v, e = g["num_vertices"], g["num_edges"]
    total = 0
    for d_in, h, f, skip in zip(cfg["widths"], cfg["heads"], cfg["head_dims"], cfg["skip"]):
        hf = h * f
        total += 2 * v * d_in * hf * (2 if skip else 1) + 4 * v * hf + 2 * e * hf
    return float(total)


def read(ctx):
    w = ctx["window"]
    if not ctx.get("trace") or not w["passes"] or "heads" not in ctx.get("config", {}):
        return None
    return 100.0 * flops_per_pass(ctx) / (w["seconds"] / w["passes"] * H100["peak_flops_f32"])
