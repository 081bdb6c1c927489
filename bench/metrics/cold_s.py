"""The cold store's host seconds per pass: the ``cold`` category's
self-seconds in the program's trace (rows evicted to it, ``cold_put``, and
reloaded from it, ``cold_take``), per pass over the window's whole
``infer`` calls."""


def read(ctx):
    return ctx.get("ooc", {}).get("category_seconds", {}).get("cold")
