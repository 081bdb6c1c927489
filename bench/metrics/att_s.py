"""GAT's attention, device seconds per pass: CUDA events on the card around
each GAT layer step's score .. normalize phases (``dist/mesh.py``
``GATLayerStep.attention_seconds``, recorded only with an enabled
tracer), summed over the window's layers, over its whole passes."""


def read(ctx):
    return ctx.get("att_s")
