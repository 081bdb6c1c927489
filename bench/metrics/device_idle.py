"""The device's idle share of the traced window, %: 1 − the union of its
operations' intervals (kernels, copies, sets) over the window."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
