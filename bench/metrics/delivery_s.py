"""The program's trace's ``layer`` self-seconds per pass
(``AtlasConfig(trace=True)``), over the window's whole ``infer`` calls,
as ``ooc_pass_s``: host delivery in ``core/atlas.py``'s ``_deliver``, the
five steps under one span."""


def read(ctx):
    seconds = ctx.get("ooc", {}).get("category_seconds", {})
    return seconds.get("layer")
