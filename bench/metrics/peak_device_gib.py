"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GiB."""

GIB = float(1 << 30)


def read(ctx):
    peak = ctx.get("peak_device_bytes")
    return None if peak is None else peak / GIB
