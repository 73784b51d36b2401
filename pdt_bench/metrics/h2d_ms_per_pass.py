"""Host-to-device copy time a pass: the device time of the trace's
``Memcpy HtoD`` records over the traced passes (host staging and upload)."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(c.end - c.start for c in ctx.trace.copies if "HtoD" in c.name)
    if s <= 0:
        return None
    return {"value": s * 1e3 / ctx.passes, "unit": "ms"}
