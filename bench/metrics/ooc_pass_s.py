"""Seconds per out-of-core pass: the window's seconds over its whole
``infer`` calls, the same calls that ``delivery_s`` divides over (host
clock)."""


def read(ctx):
    if "ooc" not in ctx:
        return None
    w = ctx["window"]
    return w["seconds"] / w["passes"]
