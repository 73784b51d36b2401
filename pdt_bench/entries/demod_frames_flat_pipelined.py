"""The entry ``demod_frames_flat_pipelined``: the program's whole-file fast
path, ``parallel/blocked.py::demod_frames_flat_pipelined``, on a pass's
int16 host planes.  Host staging in slices, pinned uploads overlapping
the compute of the slice before, the block windows cut on the card, the
carrier estimate, the chain's kernels, framing and stitching, the frames
fetched and labelled on the host.

An entry module is found by the name a traffic file gives under
``entry`` and offers:

- ``build(cfg, args, p, t_ext, gain, device)``: the program's callable
  for one request, with a ``work`` dict of what fixes its work;
- ``frames(out)``: a call's output as [(time s, inverted, payload bytes)];
- ``reference(cfg, args, p, t_ext, gain, arith=None)``: the plain
  reference's frames of the same request in the same form (``arith``
  sets its precision; the control computes it in bfloat16);
- ``pass_work(cfg, args)``: each hand kernel's bytes and operations a
  request, for the roofline share, or None.
"""

from __future__ import annotations

from pdt_bench import reference as plain
from pdt_bench import roofline


class Program:
    """One call decodes the whole pass and returns the program's frames."""

    def __init__(self, cfg, args: dict, p, t_ext, gain: float, device):
        from project_desert_tortoise_tpu_torch import chain
        from project_desert_tortoise_tpu_torch.parallel import blocked
        from project_desert_tortoise_tpu_torch.utils.config import MODES
        mode = MODES[cfg["mode"]]
        self.fn = blocked.demod_frames_flat_pipelined
        self.fs = float(cfg["fs"])
        self.params = chain.make_params(mode, self.fs)
        self.framer = mode.framer
        pl = cfg["plan"]
        self.plan = blocked.BlockPlan(pl["core"], pl["head"], pl["tail"],
                                      pl["max_frames"])
        self.lanes = -(-len(p.re16) // pl["core"])
        if self.lanes != pl["lanes"]:
            raise ValueError(f"the pass needs {self.lanes} blocks, the "
                             f"configuration states {pl['lanes']}")
        self.args, self.p, self.t_ext, self.gain = args, p, t_ext, gain
        self.device = device
        self.work = {"lanes": self.lanes, "slices": args["n_slices"]}

    def __call__(self):
        a = self.args
        return self.fn(self.params, self.framer, self.plan, self.lanes,
                       self.fs, a["window"], a["use_pallas"], self.p.re16,
                       self.p.im16, self.t_ext, self.gain,
                       n_slices=a["n_slices"], tgen=a["tgen"],
                       pack=a["pack"], device=self.device)


def build(cfg, args: dict, p, t_ext, gain: float, device) -> Program:
    return Program(cfg, args, p, t_ext, gain, device)


def frames(out):
    return [(f.time, f.inverted, bytes(f.data)) for f in out]


def reference(cfg, args: dict, p, t_ext, gain: float, arith=None):
    ref = plain.reference_frames(cfg, args["window"], p.re16, p.im16, gain,
                                 arith)
    return [(float(t_ext[pos]), inv, data) for pos, inv, data in ref]


def pass_work(cfg, args: dict):
    return roofline.pass_work(cfg["plan"]["lanes"], plain.plan_of(cfg).total,
                              int(cfg["fir"]["interp"]), args["window"],
                              plain.chain_of(cfg).step_size)
