"""The FLOP counter against hand counts: a multiply-add is 2 FLOPs, a conv
output element of a KxK conv over C channels costs 2 * K * K * C."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import Block, MsImageDis


def count(module, x):
    with FlopCounterMode(display=False) as c, torch.no_grad():
        module(x)
    return c.get_total_flops()


def test_resblock_conv():
    with torch.device("meta"):
        blk = Block(256, 256, 3, 1, 1, "in", "relu", None)
        x = torch.zeros(8, 256, 64, 64)
    assert count(blk, x) == 2 * 8 * 64 * 64 * 9 * 256 * 256


def test_upsample_conv_counts_the_direct_5x5_on_the_upsampled_map():
    with torch.device("meta"):
        blk = Block(256, 128, 5, 1, 2, "ln", "relu", None, upsample=True)
        x = torch.zeros(8, 256, 64, 64)
    assert count(blk, x) == 2 * 8 * 128 * 128 * 25 * 256 * 128


def test_one_discriminator_scale():
    d = {"dim": 64, "n_layer": 4, "num_scales": 1}
    with torch.device("meta"):
        dis = MsImageDis(d, 3)
        x = torch.zeros(8, 256, 256, 3)
    hand, c_in, c, hw = 0, 3, 64, 256
    for _ in range(4):
        hw //= 2
        hand += 2 * 8 * hw * hw * 16 * c_in * c
        c_in, c = c, 2 * c
    hand += 2 * 8 * hw * hw * c_in * 1
    assert count(dis, x) == hand
