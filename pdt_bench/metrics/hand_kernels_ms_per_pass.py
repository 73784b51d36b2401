"""The program's hand-written kernels' time a pass: the CUDA events that
the program's launch hook (``ops/kernels/common.py::launch_events``)
records around each launch, summed over the traced passes."""


def read(ctx):
    ms = sum(ctx.launch_ms.values())
    if ms <= 0:
        return None
    return {"value": ms / ctx.passes, "unit": "ms",
            "by_kernel": {k: v / ctx.passes
                          for k, v in sorted(ctx.launch_ms.items())}}
