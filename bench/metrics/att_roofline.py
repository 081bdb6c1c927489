"""GAT's attention kernels' share of their roofline, %: the least time the
card needs for each layer's scores, attention-weighted sums and
normalisation, each byte once and the FLOPs at the f32 peak, over the
device time of the ``segment_attention`` kernels
(``csrc/segment_attention.cu``: scores, the sums, the slabs' combine,
the normalisation) in the traced window.

Per layer of H heads of F (``HF = H·F``) over V vertices and E edges, one
segment a destination (the one-shard plan), f32:
- scores: ``z [V, HF]`` read, ``s``, ``t [V, H]`` written; ``4·V·HF`` FLOPs;
- the sums: ``z``, ``s``, the segments' ``t`` read, ``E`` source indices,
  ``V + 1`` offsets; ``num [V, HF]``, ``den``, ``mx [V, H]`` written;
  ``2·E·HF`` FLOPs;
- normalisation: ``num``, ``den``, ``mx``, ``V`` rows, ``V + 1`` offsets,
  the bias and (a layer with a skip) ``skip [V, HF]`` read; the output
  ``[V, HF]`` (concatenated) or ``[V, F]`` (the mean) written; ``2·V·HF``
  FLOPs.
"""

from bench.devtrace import family_seconds
from bench.frozen.roofline import H100

PATTERNS = ("segment_attention",)  # csrc/segment_attention.cu


def bound_s(v: int, e: int, heads: int, f: int, concat: bool, skip: bool) -> float:
    hf = heads * f
    parts = [  # (bytes, FLOPs)
        (4 * (v * hf + 2 * hf + 2 * v * heads), 4 * v * hf),
        (4 * (v * hf + 2 * v * heads + e + v + 1 + v * hf + 2 * v * heads), 2 * e * hf),
        (4 * (v * hf + 2 * v * heads + 2 * v + 1 + hf + (v * hf if skip else 0)
              + v * (hf if concat else f)), 2 * v * hf),
    ]
    return sum(max(b / H100["hbm_bw"], fl / H100["peak_flops_f32"]) for b, fl in parts)


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    seconds = family_seconds(trace, PATTERNS)
    if seconds <= 0:
        return None
    g, cfg = ctx["graph"], ctx["config"]
    need = sum(bound_s(g["num_vertices"], g["num_edges"], h, f, c, s)
               for h, f, c, s in zip(cfg["heads"], cfg["head_dims"], cfg["concat"], cfg["skip"]))
    return 100.0 * ctx["window"]["passes"] * need / seconds
