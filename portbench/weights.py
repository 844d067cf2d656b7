"""Seeded weights in MUNIT's state-dict layout, made on the device.

Every member of every group gets its tensors from one ``torch.Generator``
on the run's device, seeded by the run's seed, which goes on to draw the
run's inputs: per group and member, one
normal draw for all its weights and one uniform draw for its LayerNorm
scales, then each weight scaled in place. Generators take He-normal
weights (std sqrt(2 / fan_in), Council-GAN's ``init: kaiming``), the
discriminators N(0, 0.02) (MUNIT's ``gaussian``), every bias 0, LayerNorm
gamma U[0, 1) and beta 0. The same tensors go to the program and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.step import GROUPS, build

StateDict = Dict[str, torch.Tensor]


def _member(shapes: Dict[str, torch.Size], group: str,
            gen: torch.Generator, device) -> StateDict:
    weights = [k for k, s in shapes.items()
               if k.endswith("weight") and len(s) >= 2]
    flat = torch.randn(sum(shapes[k].numel() for k in weights),
                       generator=gen, device=device)
    gammas = [k for k in shapes if k.endswith("norm.gamma")]
    uni = torch.rand(sum(shapes[k].numel() for k in gammas), generator=gen,
                     device=device)
    sd: StateDict = {}
    off = 0
    for k in weights:
        s = shapes[k]
        std = (math.sqrt(2.0 / math.prod(s[1:])) if group == "gen"
               else 0.02)
        sd[k] = flat[off:off + s.numel()].view(s).mul_(std)
        off += s.numel()
    off = 0
    for k in gammas:
        sd[k] = uni[off:off + shapes[k].numel()].view(shapes[k])
        off += shapes[k].numel()
    for k, s in shapes.items():
        if k not in sd:
            fill = 1.0 if k.endswith("running_var") else 0.0
            sd[k] = torch.full(s, fill, device=device)
    return sd


def make_state(cfg: dict, gen: torch.Generator, device,
               groups=GROUPS) -> Dict[str, List[StateDict]]:
    """``{group: [N state dicts]}`` for the configuration's ``config``
    dict, drawn from ``gen`` (a generator on ``device``)."""
    n = cfg["council"]["council_size"]
    out = {}
    for group in groups:
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in
                      build(cfg, group, device="meta").state_dict().items()}
        out[group] = [_member(shapes, group, gen, device) for _ in range(n)]
    return out
