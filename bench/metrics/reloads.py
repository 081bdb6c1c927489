"""Rows reloaded from the cold store per pass: ``LayerMetrics.reloads``
summed over a pass's layers, mean over the passes run."""


def read(ctx):
    passes = ctx.get("ooc", {}).get("layer_metrics")
    if not passes:
        return None
    return sum(m["reloads"] for ms in passes for m in ms) / len(passes)
