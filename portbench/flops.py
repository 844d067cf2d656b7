"""Model FLOPs of the published equations, counted on the ``meta`` device.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix work
(convolutions and their backward, linear layers) that the plain reference
does at a cell's shapes: each upsample stage as a nearest 2x upsample and a
direct 5x5 convolution, as MUNIT writes it. The count depends on the
configuration and the shapes alone, whatever engine the program runs.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.step import GROUPS, Council, build


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def serve_flops(cfg: dict, hw: int) -> int:
    """FLOPs of one member's translation of one image (content encoder,
    MLP, decoder)."""
    with torch.device("meta"):
        gen = build(cfg, "gen", device="meta")
        x = torch.zeros(1, hw, hw, 3)
        z = torch.zeros(1, cfg["gen"]["style_dim"])
    with torch.no_grad():
        return _count(lambda: gen.translate(x, z))


def train_flops(cfg: dict, batch: int, hw: int) -> int:
    """FLOPs of one train step of the whole council at ``batch`` images per
    domain: every phase that the configuration turns on, forward and
    backward."""
    n = cfg["council"]["council_size"]
    with torch.device("meta"):
        state = {grp: [build(cfg, grp, device="meta").state_dict()
                       for _ in range(n)] for grp in GROUPS}
        council = Council(cfg, state, device="meta")
        x_a = torch.zeros(batch, hw, hw, 3)
        x_b = torch.zeros(batch, hw, hw, 3)
        z = torch.zeros(n, batch, cfg["gen"]["style_dim"])
    return _count(lambda: council.step(x_a, x_b, z))
