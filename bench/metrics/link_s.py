"""Seconds per pass of the aggregation stage's copies over the link, timed
on the card by CUDA events on the aggregator's stream:
``LayerMetrics.h2d_device_seconds + d2h_device_seconds`` over a pass's
layers, mean over the passes run."""

FIELDS = ("h2d_device_seconds", "d2h_device_seconds")


def read(ctx):
    passes = ctx.get("ooc", {}).get("layer_metrics")
    if not passes or any(f not in m for ms in passes for m in ms for f in FIELDS):
        return None
    return sum(m[f] for ms in passes for m in ms for f in FIELDS) / len(passes)
