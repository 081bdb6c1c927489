"""Seconds from process start to the first timed pass (host clock):
inputs, the program's set-up, CUDA init, kernels loaded or built, warm-up."""


def read(ctx):
    return ctx["setup_s"]
