"""The eviction policy's host seconds per pass: the ``policy`` category's
self-seconds in the program's trace (victim selection and the policy's
bookkeeping, called from ``core/memory_manager.py``), per pass over the
window's whole ``infer`` calls."""


def read(ctx):
    return ctx.get("ooc", {}).get("category_seconds", {}).get("policy")
