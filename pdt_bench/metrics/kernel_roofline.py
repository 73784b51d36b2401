"""The hand kernels' share of their roofline: the least time an H100
could take on a pass's kernel work (``roofline.py``, counted from the
cell's shapes) over the kernels' measured time a pass (the launch hook's
CUDA events)."""

from pdt_bench import roofline


def read(ctx):
    ms = sum(ctx.launch_ms.values())
    if ms <= 0 or not ctx.work:
        return None
    least, by = roofline.least_ms(ctx.work)
    return {"value": 100.0 * least / (ms / ctx.passes), "unit": "%",
            "bound_by": by, "least_ms": least,
            "power_limit_w": ctx.power_limit_w}
