"""Peak pinned host bytes of PyTorch's caching host allocator
(``torch.cuda.host_memory_stats``), reset at the window's start, in GiB."""

GIB = float(1 << 30)


def read(ctx):
    peak = ctx.get("ooc", {}).get("pinned_peak_bytes")
    return None if peak is None else peak / GIB
