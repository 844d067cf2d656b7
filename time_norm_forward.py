#!/usr/bin/env python3
"""Device time of one councilx_torch tree's IN/AdaIN forward on one GPU.

    python3 time_norm_forward.py [--tree DIR]

Imports ``councilx_torch`` from DIR (default: this checkout) and
``chip_smoke.py`` from this checkout, for its shapes and its device timer,
so two trees (one unpacked with ``git archive``) are timed by the same
code on one card: run it once per tree, in turns (parent, change, change,
parent). At each norm site of the main paths (``chip_smoke.NORM_SHAPES``),
at batch 1 of the 256x256 site and at serving's bucket 64, in bf16 and
f32, it prints the median device ms of ``instance_norm(x)`` (K3) from
``chip_smoke.time_turns`` and its largest error against the plain version;
the same for AdaIN (K4) at the first site. Imports nothing of JAX or
``councilx``.
"""

import argparse
import importlib.util
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout whose councilx_torch is timed")
    tree = os.path.abspath(ap.parse_args().tree)
    if not torch.cuda.is_available():
        raise SystemExit("time_norm_forward: no CUDA device")
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import councilx_torch
    from councilx_torch.ops.instance_norm import (instance_norm,
                                                  instance_norm_reference)

    card_str = cs.card()
    cs.log(f"[norm_fwd] councilx_torch from {councilx_torch.__file__}")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, _, _, c = cs.NORM_SHAPES[0]
    gm = torch.randn(b, c, device="cuda", generator=g)
    bt = torch.randn(b, c, device="cuda", generator=g)
    cases = [("instance_norm", shape, ()) for shape in cs.NORM_SHAPES + (
        (1, 256, 256, 64), cs.NORM_BUCKET64)]
    cases.append(("adain", cs.NORM_SHAPES[0], (gm, bt)))
    for dt in (torch.bfloat16, torch.float32):
        for name, shape, affine in cases:
            x = (torch.randn(*shape, device="cuda", generator=g) * 3
                 + 1).to(dt)
            err = (instance_norm(x, *affine).float() - instance_norm_reference(
                x, *affine).float()).abs().max().item()
            ms, = cs.time_turns(lambda: instance_norm(x, *affine))
            cs.log(f"[norm_fwd] {name} {str(dt)[6:]} {shape}: {ms:.6g} ms, "
                   f"max_abs_err {err:.6g} [{card_str}]")


if __name__ == "__main__":
    main()
