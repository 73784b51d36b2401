"""Host time a pass spent pinning the slices' planes: the host time of
the outermost ``aten::pin_memory`` / ``aten::_pin_memory`` operations of
the traced passes (host staging and upload)."""

NAMES = ("aten::pin_memory", "aten::_pin_memory")


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(o.end - o.start for o in ctx.trace.host_ops if o.name in NAMES)
    if s <= 0:
        return None
    return {"value": s * 1e3 / ctx.passes, "unit": "ms"}
