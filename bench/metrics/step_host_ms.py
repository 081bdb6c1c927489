"""Host milliseconds from a layer-step call to its return, no
synchronize, mean over the window's calls: what the host spends
enqueuing one layer of ``dist/mesh.py``'s ``LayerStep``."""


def read(ctx):
    return ctx.get("step_host_ms")
