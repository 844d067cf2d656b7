#!/usr/bin/env python3
"""Device and host time of one councilx_torch tree's W8A8 kernels on one GPU.

    python3 time_quant.py [--tree DIR]

Imports ``councilx_torch`` from DIR (default: this checkout) and
``chip_smoke.py`` from this checkout, for its sites and its timers, so two
trees (one unpacked with ``git archive``) are timed by the same code on one
card: run it once per tree, in turns (parent, change, change, parent). At
each of the five conv sites of quantized serving (``chip_smoke.QUANT_SITES``,
bucket 8, bf16) it prints, for Q2 (``quantize_act``, static and per image)
and Q1 (``conv_int8``, bf16 out with its bias), the median device ms from
``chip_smoke.time_turns``, the host us per wrapper call from
``chip_smoke.host_us``, the device launches per call, and whether the
result is bit-equal to the plain version; first, Q2's time at a tiny
input (8 x 8 x 8 x 256), its fixed cost in each mode. ``--tiles`` also
times Q1 at every tile its kernel takes for the site (K steps of 128 or
64 bytes, 128- or 256-channel tiles; ``ops/quant.py::_conv_tiles`` picks
one), each held bit-equal too. Imports nothing of JAX or ``councilx``.
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
    ap.add_argument("--tiles", action="store_true",
                    help="also time Q1 at every tile it takes")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if not torch.cuda.is_available():
        raise SystemExit("time_quant: no CUDA device")
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import councilx_torch
    from councilx_torch.ops import quant as q_ops

    card_str = cs.card()
    cs.log(f"[quant_time] councilx_torch from {councilx_torch.__file__}")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    # Q2's fixed cost: both modes at 8 images of 8 x 8 x 256, 0.2 MB
    tiny = (torch.randn(8, 8, 8, 256, device="cuda", generator=g)).to(dt)
    for mode, a_scale in (("static", tiny.float().abs().amax() / 127),
                          ("per image", None)):
        ms, = cs.time_turns(lambda a=a_scale: q_ops.quantize_act(
            tiny, 1, "reflect", a))
        cs.log(f"[quant_time] Q2 {mode} tiny {tuple(tiny.shape)}: {ms:.6g} "
               f"ms [{card_str}]")
    for site, spec_ in cs.QUANT_SITES.items():
        (b, h, w, c), pad, pad_type, k, stride, o = spec_
        x = (torch.randn(b, h, w, c, device="cuda", generator=g) * 2).to(dt)
        kern = torch.randn(k, k, c, o, device="cuda",
                           generator=g) / (k * k * c) ** 0.5
        bias = torch.randn(o, device="cuda", generator=g) * 0.1
        wq = q_ops.quantize_weights(kern)
        a_static = (x.float().abs().amax() * 0.9 / 127).reshape(())
        for mode, a_scale in (("static", a_static), ("per image", None)):
            def q2(a=a_scale):
                return q_ops.quantize_act(x, pad, pad_type, a)
            got_q, got_s = q2()
            want_q, want_s = q_ops.quantize_act_reference(x, pad, pad_type,
                                                          a_scale)
            same = (torch.equal(got_q[..., :c], want_q)
                    and torch.equal(got_s.reshape(-1), want_s.reshape(-1)))
            ms, = cs.time_turns(q2)
            cs.log(f"[quant_time] Q2 {mode} {site} {tuple(x.shape)}: "
                   f"{ms:.6g} ms, host {cs.host_us(q2):.6g} us per call, "
                   f"{_launches_per_call(q2)} device launch(es), bit-equal "
                   f"{same} [{card_str}]")
        q, a_s = q_ops.quantize_act_reference(x, pad, pad_type)

        def q1():
            return q_ops.conv_int8(q, wq, a_s, bias, stride, dt)
        same = torch.equal(q1(), q_ops.conv_int8_reference(q, wq, a_s, bias,
                                                           stride, dt))
        ms, = cs.time_turns(q1)
        cs.log(f"[quant_time] Q1 {site} {tuple(q.shape)} {k}x{k}/{stride} "
               f"-> {o}: {ms:.6g} ms, host {cs.host_us(q1):.6g} us per "
               f"call, {_launches_per_call(q1)} device launch(es), bit-equal "
               f"{same} [{card_str}]")
        if args.tiles:
            _time_tiles(cs, q_ops, q1, q, wq, a_s, bias, stride, site,
                        card_str)


def _time_tiles(cs, q_ops, q1, q, wq, a_s, bias, stride, site, card_str):
    """Q1 at each (K step bytes, N tile) its kernel takes here."""
    chosen = q_ops._conv_tiles
    want = q_ops.conv_int8_reference(q, wq, a_s, bias, stride, q1().dtype)
    cq = q.shape[-1]
    try:
        for bk in (128, 64) if cq % 128 == 0 else (64,):
            for bn in (256, 128):
                q_ops._conv_tiles = lambda c, o, t=(bk, bn): t
                same = torch.equal(q1(), want)
                ms, = cs.time_turns(q1)
                mark = (" (chosen)" if (bk, bn) == chosen(cq, wq.w8.shape[0])
                        else "")
                cs.log(f"[quant_time] Q1 tiles {site} K step {bk} B, {bn} "
                       f"channels{mark}: {ms:.6g} ms, bit-equal {same} "
                       f"[{card_str}]")
    finally:
        q_ops._conv_tiles = chosen


def _launches_per_call(fn) -> int:
    """Device kernels one call of fn runs, from a profiler trace (taken
    again, up to three times, where it holds no device event at all: the
    profiler now and then drops a whole trace)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n:
            break
    return n


if __name__ == "__main__":
    main()
