"""A GAT run's features and weights from its seed, on the device, with
one ``torch.Generator`` in two large calls, in float32 (``inputs.py``'s
rule for the other configurations; the graph is ``inputs.make_graph``'s).

Features standard normal over sqrt(d).  Per layer k of H heads of F:
``w [d_in, H·F]`` and ``w_skip`` (where ``skip[k]``) Glorot-uniform;
``a_src``, ``a_dst [H, F]`` uniform in ``±att_scale[k]·sqrt(3/F)``, so
each head's vector has a norm of about ``att_scale[k]`` (the
configuration's ``assumed``: chosen so that the scores spread by about
3, as a trained GAT's do); ``b [H·F]`` uniform in ``±bias_scale``.  Both
sides of a run, program and reference, get these same tensors.
"""

from __future__ import annotations

import math

import torch

from bench.inputs import seed64


def layer_shapes(config: dict) -> list[dict]:
    """Each layer's ``d_in``, ``heads``, ``f``, ``concat`` and ``skip``."""
    widths = config["widths"]
    return [{"d_in": widths[k], "heads": h, "f": f, "concat": bool(c), "skip": bool(s)}
            for k, (h, f, c, s) in enumerate(zip(config["heads"], config["head_dims"],
                                                 config["concat"], config["skip"]))]


def make_tensors(config: dict, num_vertices: int, seed: int, device) -> tuple:
    """``(x, layers)``: features ``[V, widths[0]]`` and per layer a dict of
    ``w``, ``a_src``, ``a_dst``, ``b`` and (where it has one) ``w_skip``."""
    assumed = config["assumed"]
    bias_scale, att_scale = float(assumed["bias_scale"]), assumed["att_scale"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    d0 = config["widths"][0]
    x = torch.randn(num_vertices, d0, generator=gen, device=device).mul_(1.0 / math.sqrt(d0))
    shapes = layer_shapes(config)
    parts = []
    for k, s in enumerate(shapes):
        hf = s["heads"] * s["f"]
        glorot = math.sqrt(6.0 / (s["d_in"] + hf))
        att = float(att_scale[k]) * math.sqrt(3.0 / s["f"])
        parts.append([("w", (s["d_in"], hf), glorot), ("a_src", (s["heads"], s["f"]), att),
                      ("a_dst", (s["heads"], s["f"]), att), ("b", (hf,), bias_scale)]
                     + ([("w_skip", (s["d_in"], hf), glorot)] if s["skip"] else []))
    sizes = [math.prod(shape) for layer in parts for _, shape, _ in layer]
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    chunks = iter(torch.split(u, sizes))
    layers = [{name: (next(chunks).view(shape) * scale).contiguous()
               for name, shape, scale in layer} for layer in parts]
    return x, layers
