"""The share of the traced window with no kernel, copy or fill on the
device."""

from pdt_bench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.window
    busy = trace.busy_s(ctx.trace)
    if busy <= 0:
        return None
    return {"value": 100.0 * (1.0 - busy / (hi - lo)), "unit": "%"}
