"""Host delivery per pass, step by step: the self-seconds of the program's
trace's seven delivery categories (``deliver``, ``activate``, ``policy``,
``cold``, ``accumulate``, ``orchestrate``, ``release``: the spans of
``core/atlas.py``'s ``_deliver`` and of the memory manager's calls inside
it), summed, per pass over the window's whole ``infer`` calls
(``AtlasConfig(trace=True)``).  With ``delivery_s`` (the ``layer``
self-seconds left around them) it makes up what ``delivery_s`` read before
the steps had spans."""

CATEGORIES = ("deliver", "activate", "policy", "cold", "accumulate", "orchestrate", "release")


def read(ctx):
    seconds = ctx.get("ooc", {}).get("category_seconds", {})
    found = [seconds[c] for c in CATEGORIES if c in seconds]
    return sum(found) if found else None
