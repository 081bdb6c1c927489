"""GiB read and written per pass, cold store included
(``LayerMetrics.bytes_read + bytes_written + cold_bytes_read +
cold_bytes_written`` over a pass's layers, mean over the passes run)."""

GIB = float(1 << 30)
FIELDS = ("bytes_read", "bytes_written", "cold_bytes_read", "cold_bytes_written")


def read(ctx):
    passes = ctx.get("ooc", {}).get("layer_metrics")
    if not passes:
        return None
    return sum(m[f] for ms in passes for m in ms for f in FIELDS) / len(passes) / GIB
