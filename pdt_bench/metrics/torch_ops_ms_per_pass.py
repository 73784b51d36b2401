"""PyTorch's kernels' device time a pass (the FIR's convolution, framing,
bit compaction, the carrier estimate, the windows cut on the card): the
trace's kernels launched from inside a PyTorch operation."""


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(k.end - k.start for k in ctx.trace.kernels)
    if s <= 0:
        return None
    return {"value": s * 1e3 / ctx.passes, "unit": "ms"}
