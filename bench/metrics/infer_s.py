"""Seconds per full-graph pass: the window's seconds over the whole
passes it completed (host clock, each pass ending in a synchronize)."""


def read(ctx):
    w = ctx["window"]
    return w["seconds"] / w["passes"] if w["passes"] else None
