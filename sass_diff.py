#!/usr/bin/env python3
"""Whether the kernels of one checkout compile to the same machine code as
another's: ``nvcc`` builds each ``csrc/*.cu`` source of both checkouts to
a cubin with the package's flags, ``cuobjdump -sass`` disassembles it, and
every function of the first checkout (by its instructions, the name
aside, since a function that became a template changes its name) must
have an identical body in the second.

    python3 sass_diff.py PARENT [ROOT]

ROOT defaults to this checkout.  Prints one JSON line a source present in
both: the functions in each, the first checkout's functions with no
identical body in the second (empty when nothing changed) and the second's
functions whose bodies are new (such as a new double instance); then one
line with ``identical`` true when no function of the first checkout
changed.  Exits 1 otherwise.  Needs ``nvcc`` and ``cuobjdump`` (a CUDA
toolkit), no card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import tempfile

CSRC = os.path.join("project_desert_tortoise_tpu_torch", "csrc")
INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass(nvcc: str, flags, src: str, workdir: str) -> dict:
    """{function name: its instructions} of one source."""
    out = os.path.join(workdir, src.replace(os.sep, "_") + ".cubin")
    subprocess.run([nvcc, *flags, "-cubin", "-o", out, src], check=True,
                   capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", out], check=True,
                          capture_output=True, text=True).stdout
    funcs = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        funcs[name.strip()] = tuple(
            m.group(1) for m in map(INSTRUCTION.match, body.splitlines())
            if m)
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the checkout compared against")
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    from project_desert_tortoise_tpu_torch.ops.kernels import build
    nvcc = build.nvcc_path()
    # the library's flags, without the link-only and verbose ones
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-Xptxas=-v", "-Xcompiler", "-fPIC")]
    names = sorted(set(os.listdir(os.path.join(args.parent, CSRC)))
                   & set(os.listdir(os.path.join(args.root, CSRC))))
    sources = [n for n in names if n.endswith(".cu")]
    same = True
    with tempfile.TemporaryDirectory() as wd, \
            concurrent.futures.ThreadPoolExecutor(2 * len(sources)) as ex:
        jobs = {(n, side): ex.submit(sass, nvcc, flags,
                                     os.path.join(root, CSRC, n), wd)
                for n in sources
                for side, root in (("old", args.parent), ("new", args.root))}
        for n in sources:
            old, new = jobs[n, "old"].result(), jobs[n, "new"].result()
            bodies, old_bodies = set(new.values()), set(old.values())
            changed = [k for k, v in old.items() if v not in bodies]
            same &= not changed
            print(json.dumps(dict(
                source=n, functions=len(old), functions_now=len(new),
                changed=changed,
                new=[k for k, v in new.items() if v not in old_bodies])))
    print(json.dumps({"identical": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
