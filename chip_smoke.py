#!/usr/bin/env python3
"""Drive councilx_torch's serving and training paths once on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Runs from the root of a checkout; imports nothing of JAX or ``councilx``.
Phases, in order; any failure raises and exits non-zero:

1. device: a CUDA card is required; print its name and power limit;
2. build: compile the CUDA kernels from the checkout's sources
   (``CUDA_SOURCES``: conv3x3 forward and dgrad, conv3x3 wgrad, the
   IN/AdaIN forward, the IN/AdaIN backward; one ``nvcc`` per source, in
   parallel);
3. each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes, in bf16 and f32 (TF32 off for the
   plain versions): max abs error against a stated tolerance; median
   device times (:func:`device_ms`) of the kernel, its plain version and
   one PyTorch library call that computes the same function (a yardstick
   the port never calls), and the least time the card could take
   (:func:`bound_ms`); the conv's host time per call; the wgrad and the
   norm kernels twice each, bit-equal; the norm forward's f32 mean and
   rstd held too, also at serving's bucket 64 (its plain launch);
4. the serving slice at full width (council-4, 256px, dim 64, n_res 4,
   bf16, random weights from a seed): 4 members saved as a reference
   ``.pt``, loaded through ``councilx_torch.cli.serve.build_engine``,
   concurrent uint8 requests from threads, results checked against direct
   ``Translator`` calls and the kernels' launch counts checked per member
   forward; then the council ensemble (``member="all"``);
5. accuracy of the serving path: the card's bf16 and f32 kernel paths
   against the port on the CPU in f32, which uses the plain versions;
6. the train step at full width (``bench.py::headline_config``: council-4,
   256px, batch 8, bf16, focus mask, a2b) through
   ``CouncilTrainer.train_step``: 2 warm steps, 10 timed steps, every
   metric finite, img/s and peak memory, and the launch counts of the
   forward and backward kernels checked against each other;
7. accuracy of the training path: a reduced config's first two steps on
   the card (f32 parity mode, then bf16) against the port on the CPU from
   the same weights, batch and z;
8. train-cli: the user's path at the same width: seeded JPEG folders
   (trainA/B, testA/B, 32 images each, ~300x280) under ``build/``,
   ``python -m councilx_torch.cli.train``'s ``main`` for 6 steps (log
   every 2, sample sheets and async snapshots every 3), then ``--resume``
   for 2 more: resumed at 6, ended at 8, finite metrics logged at steps 2,
   4, 6 and 8, the launch invariants over the loop's steps, every kernel
   launched; then ``cli.translate --member all`` on testA and one
   ``cli.gui`` render from the step-8 snapshot. Prints the loop's img/s
   beside phase 6's, the snapshot's size and the seconds its save held the
   loop, and which decode path ran;
9. eval (run after phase 5, beside phase 4's checkpoint):
   ``python -m councilx_torch.cli.eval``'s ``main`` on phase 4's
   council-4 checkpoint, ``--member all --kid --allow-random --batch_size
   16``, over phase 8's seeded folders (32 images in testA, 32 in testB):
   every member's FID finite, the best member their argmin, 32 images
   translated, and the kernels' launches over the call those of 4 members
   x 2 batches; member 0's translate of the call's first batch (16
   images, its z) on the card, bf16 and f32, held against the CPU at
   phase 5's tolerances; the card's Inception features (float32; the
   module turns TF32 off itself, so the script turns it on around the
   call) held against the same module on the CPU for the same 4 images,
   and the two FIDs against each other; a ``TrainEvalHook`` on a
   headline-config trainer (16 images, every member, random weights)
   called once, then its translate + feature pass twice more on the same
   state: bit-equal, the training z stream untouched. Prints translate and
   Inception img/s on the card, the PIL preprocessing ms per image, the
   FID's seconds (its 2048x2048 sqrtm on the host) and the hook's seconds
   per call.

Phase 3 also holds two inputs the kernels once refused: the norm backward
at batch 128 (more groups than one cooperative launch holds: its plain
launch) and the conv, dgrad and wgrad at C = 12, O = 20 (channels padded to
multiples of 8 around the same kernels); and the eval path's kernels at
its batch of 16 (the conv, the norm forward at its three sites, AdaIN).

The line before the last is one JSON object describing every kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from councilx_torch.cli.serve import build_engine
from councilx_torch.config import Config
from councilx_torch.inference.translate import Translator, _u8_from_unit
from councilx_torch.ops import _build
from councilx_torch.ops import conv3x3 as conv_ops
from councilx_torch.ops import instance_norm as norm_ops
from councilx_torch.ops.conv3x3 import (conv3x3_dgrad,
                                        conv3x3_dgrad_reference,
                                        conv3x3_valid, conv3x3_valid_reference,
                                        conv3x3_wgrad, conv3x3_wgrad_reference,
                                        hwio_weight)
from councilx_torch.ops.instance_norm import (
    instance_norm, instance_norm_backward, instance_norm_backward_reference,
    instance_norm_forward_reference)
from councilx_torch.train.trainer import CouncilTrainer

# configs/soak_256_council4.yaml, the flagship serving model
FLAGSHIP = {
    "compute_dtype": "bfloat16",
    "council": {"council_size": 4, "council_w": 0.2,
                "council_start_at_iter": 0},
    "focus_loss": {"focus_enabled": True, "mask_total_w": 0.005,
                   "mask_zero_or_one_w": 0.005},
    "gen": {"dim": 64, "mlp_dim": 256, "style_dim": 8, "n_downsample": 2,
            "n_res": 4},
    "dis": {"dim": 64, "n_layer": 4, "num_scales": 3},
    "new_size": 270, "crop_image_height": 256, "crop_image_width": 256,
}
HW = 256
BATCH = 8
N_MEMBERS = 4
# kernel launches per member forward (encode_content + decode): 8 encoder +
# 8 decoder resblock convs; 11 IN (7x7, two stride-2, 8 resblock) + 8 AdaIN
CONV_PER_FWD = 16
NORM_PER_FWD = 19
ADAIN_PER_FWD = 8
# bench.py::headline_config, the train step the JAX package's bench times
HEADLINE = {
    "batch_size": 8, "compute_dtype": "bfloat16", "remat": False,
    "adam_mu_dtype": "float32", "gen_member_chunks": 1,
    "council": {"council_size": 4, "council_w": 0.2,
                "council_start_at_iter": 0},
    "focus_loss": {"focus_enabled": True},
    "gen": {"dim": 64, "mlp_dim": 256, "style_dim": 8, "n_downsample": 2,
            "n_res": 4},
    "dis": {"dim": 64, "n_layer": 4, "num_scales": 3},
    "new_size": 270, "crop_image_height": 256, "crop_image_width": 256,
}
# kernel sites per member and train step, all under autograd: the
# translation (16 conv, 19 norm of which 8 AdaIN), recon_x's decode (8
# conv, 8 AdaIN) and recon_c's content encoder (8 conv, 11 IN)
TRAIN_CONV_PER_MEMBER = 16 + 8 + 8
TRAIN_NORM_PER_MEMBER = 19 + 8 + 11
TRAIN_ADAIN_PER_MEMBER = 8 + 8
WARM_STEPS = 2
TIMED_STEPS = 10
# the reduced config of the training accuracy phase
REDUCED = {
    "batch_size": 2, "compute_dtype": "float32",
    "council": {"council_size": 2, "council_w": 0.2,
                "council_start_at_iter": 0},
    "focus_loss": {"focus_enabled": True},
    "gen": {"dim": 32, "mlp_dim": 64, "style_dim": 8, "n_downsample": 2,
            "n_res": 2},
    "dis": {"dim": 16, "n_layer": 2, "num_scales": 2},
    "new_size": 64, "crop_image_height": 64, "crop_image_width": 64,
}


# every CUDA source of councilx_torch/csrc, built in phase 2
CUDA_SOURCES = ("conv3x3", "conv3x3_wgrad", "instance_norm_fwd",
                "instance_norm_bwd")
# kernels whose two launches on the same inputs must be bit-equal
DETERMINISTIC = ("conv3x3_wgrad", "instance_norm", "adain",
                 "instance_norm_bwd", "adain_bwd")
# the norm sites of the serving and training paths (the 7x7 block's
# output, the second downsample's, the resblocks'), at bucket 8
NORM_SHAPES = ((BATCH, 64, 64, 256), (BATCH, 128, 128, 128),
               (BATCH, 256, 256, 64))
# the resblocks' norm site at serving's largest bucket (cli/serve.py
# --max_batch): one chunk per group, the norm forward's plain launch
NORM_BUCKET64 = (64, 64, 64, 256)
# inputs the kernels once refused: the norm backward at batch 128 (512
# groups, more than one cooperative launch holds: its plain launch), and
# the conv at channel counts that are not multiples of 8 (padded)
NORM_BWD_BATCH128 = (128, 64, 64, 256)
CONV_RAGGED = (BATCH, 64, 64, 12, 20)
# phase 8: the train CLI's run (steps, then resumed steps) and cadences
CLI_STEPS, CLI_RESUME_STEPS = 6, 2
CLI_CADENCE = {"log_iter": 2, "image_save_iter": 3, "image_display_iter": 3,
               "snapshot_save_iter": 3}
CLI_IMAGES = 32
# phase 9: cli.eval's translate batch and Inception batch (the CLI's
# default --feature_batch_size), the images held card against CPU, and
# the hook's images per domain
EVAL_BATCH = 16
EVAL_FEATURE_BATCH = 32
EVAL_CPU_IMAGES = 4
EVAL_HOOK_IMAGES = 16

# the card's peak rates (NVIDIA H100 SXM data sheet, dense, at the full
# 700 W): bf16 on the tensor cores, f32 on the FMA units, device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
CONV_KERNELS = ("conv3x3", "conv3x3_dgrad", "conv3x3_wgrad")
# per norm kernel: f32 operations per element (counted from the plain
# versions' arithmetic), full-size tensors moved (x and y; dy, x and dx)
# and f32 per-(sample, channel) vectors moved (mean and rstd; gamma and
# beta in for AdaIN; dgamma and dbeta out of its backward)
NORM_WORK = {"instance_norm": (5, 2, 2), "adain": (7, 2, 4),
             "instance_norm_bwd": (11, 3, 2), "adain_bwd": (13, 3, 5)}


def kernel_work(name: str, shape, esize: int = 2):
    """(operations, bytes, peak type) of one call of kernel ``name``, with
    each input read once and each output written once.

    Conv kernels: ``shape`` is (B, H, W, C, O) of the forward conv, xp
    (B, H+2, W+2, C) x k (3, 3, C, O) -> y (B, H, W, O); the dgrad reads g
    (B, H, W, O) and k and writes d(xp), the wgrad reads xp and g and
    writes dk: the same three tensors and the same 2*B*H*W*9C*O operations
    (the dgrad's padded form would run 2*B*(H+2)*(W+2)*9*O*C). Norm
    kernels: ``shape`` is (B, H, W, C)."""
    if name in CONV_KERNELS:
        b, h, w, c, o = shape
        ops = 2 * b * h * w * 9 * c * o
        elems = b * (h + 2) * (w + 2) * c + b * h * w * o + 9 * c * o
        return ops, esize * elems, "bf16" if esize == 2 else "f32"
    b, h, w, c = shape
    per_elem, full, vectors = NORM_WORK[name]
    return (per_elem * b * h * w * c,
            esize * full * b * h * w * c + 4 * vectors * b * c, "f32")


def bound_ms(name: str, shape, esize: int = 2):
    """(ms, "operations" or "bytes"): the least time the card could take
    for one call, the larger of its operations over the peak rate of
    their type and its bytes over the memory rate."""
    ops, nbytes, kind = kernel_work(name, shape, esize)
    t_ops, t_bytes = ops / PEAK_OPS[kind], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def log(*a):
    print(*a, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 15) -> list:
    """Per-launch times in ms from CUDA events."""
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return out


def device_ms(fn, reps: int = 10, calls: int = 10) -> list:
    """Device ms per call of fn, from CUDA events around ``calls`` calls.

    A sleep kernel first holds the card for about twice the host time of
    those calls, so they are all enqueued before the start event runs and
    the events bracket device work only: a kernel wrapper's host time
    (~50 us) is as long as a fast kernel, and would otherwise be timed as
    idle card."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * (2 * calls * host_s + 1e-4))   # at <= 2 GHz
    out = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / calls)
    return out


def time_turns(kernel, *others):
    """Median device ms of kernel and of each other function, timed in
    turns: the others, kernel, kernel, the others in reverse (after one
    warm launch each)."""
    kernel()
    for fn in others:
        fn()
    torch.cuda.synchronize()
    times = [device_ms(fn) for fn in others]
    k = device_ms(kernel) + device_ms(kernel)
    for i in reversed(range(len(others))):
        times[i] += device_ms(others[i])
    return [float(np.median(k))] + [float(np.median(t)) for t in times]


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call to enqueue fn (no synchronisation
    inside the n calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def conv_host_times(xp: torch.Tensor, k: torch.Tensor, gy: torch.Tensor,
                    card_str: str):
    """Host us per call of the bf16 conv: through its wrappers (forward,
    dgrad, wgrad), and of the kernel library's entry point alone (the
    forward's three tensor-map encodes and its launch); the rest of a
    wrapper call is PyTorch's."""
    fwd = host_us(lambda: conv3x3_valid(xp, k))
    dgrad = host_us(lambda: conv3x3_dgrad(gy, k))
    wgrad = host_us(lambda: conv3x3_wgrad(xp, gy, xp.dtype))
    b, hp, wp, c = xp.shape
    wk = conv_ops._kernel_weight(k, xp.dtype)
    y = torch.empty(b, hp - 2, wp - 2, wk.shape[2], dtype=xp.dtype,
                    device=xp.device)
    entry = conv_ops._conv_lib().councilx_conv3x3
    stream = torch.cuda.current_stream().cuda_stream
    lib = host_us(lambda: entry(xp.data_ptr(), wk.data_ptr(), y.data_ptr(),
                                b, hp, wp, c, wk.shape[2], 0, 0, 1, stream))
    log(f"[kernels] conv3x3 bf16 host time per call: forward wrapper "
        f"{fwd:.6g} us, dgrad wrapper {dgrad:.6g} us, wgrad wrapper "
        f"{wgrad:.6g} us; the library's entry point alone (three encodes "
        f"and the launch) {lib:.6g} us [{card_str}]")


def phase_kernels(g: torch.Generator, card_str: str) -> dict:
    """Phase 3: every kernel vs its plain version at the paths' shapes,
    with its library call and its bound beside it. The conv weight k is
    made as the model's blocks make it (``hwio_weight`` of an OIHW
    weight), so the conv wrappers' times include what they copy on the
    path.

    Tolerances, relative to the largest |plain| value m:
      bf16: 2**-6 * m (conv3x3, dgrad, norms) -- both sides sum in f32 and
            round once to bf16, so they may differ by a rounding step;
      bf16 wgrad: 2**-7 * m -- the products of bf16 inputs are exact in
            f32; each output sums B*H*W = 32768 of them in f32, in another
            order than the plain version, an error of order
            sqrt(32768) * 2**-24 ~ 1e-5 of the summed magnitudes; the
            kernel then rounds once to bf16 (2**-9 relative), which the
            tolerance covers with room;
      f32 conv and dgrad: 1e-4 * m -- f32 sums of K = 9*256 = 2304 terms
            in another order;
      f32 wgrad: 1e-4 * m -- f32 sums of 32768 terms in another order;
      f32 norm forward: 1e-5 * m -- f32 sums over HW in another order;
            the same for its f32 mean and rstd in either dtype, each
            against its own largest value;
      f32 norm backward: 1e-4 * m -- f32 sums over HW (up to 65536) in
            another order, then a difference of like terms.

    Library calls (cuDNN and ATen; the port never calls them), on the
    NCHW views of the same NHWC tensors:
      conv3x3: F.conv2d with the weight in channels-last OIHW;
      conv3x3_dgrad / conv3x3_wgrad: aten.convolution_backward from the
            unpadded g with output_mask [True, False, False] / [False,
            True, False];
      instance_norm: F.instance_norm;
      adain: F.instance_norm on x reshaped to (1, B*C, H, W) with the
            flattened per-(sample, channel) gamma and beta, as MUNIT's
            AdaptiveInstanceNorm2d computes it -- the reshape's NCHW copy
            is part of the timed call;
      instance_norm_bwd / adain_bwd: the autograd backward of those two
            calls (only the backward is timed)."""
    results = {}
    tol_rel = {("conv", torch.bfloat16): 2 ** -6,
               ("conv", torch.float32): 1e-4,
               ("wgrad", torch.bfloat16): 2 ** -7,
               ("wgrad", torch.float32): 1e-4,
               ("norm", torch.bfloat16): 2 ** -6,
               ("norm", torch.float32): 1e-5,
               ("norm_bwd", torch.bfloat16): 2 ** -6,
               ("norm_bwd", torch.float32): 1e-4}
    cases = []
    conv_shape = (BATCH, 64, 64, 256, 256)
    for dt in (torch.bfloat16, torch.float32):
        xp = torch.randn(BATCH, 66, 66, 256, device="cuda",
                         generator=g).to(dt)
        k = hwio_weight(torch.randn(256, 256, 3, 3, device="cuda",
                                    generator=g) / 48.0, dt)
        gy = torch.randn(BATCH, 64, 64, 256, device="cuda",
                         generator=g).to(dt)
        xn, gn = xp.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        wn = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)

        def conv_bwd(mask, gn=gn, xn=xn, wn=wn):
            return lambda: torch.ops.aten.convolution_backward(
                gn, xn, wn, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
                mask)

        cases.append(("conv3x3", "conv", dt, tuple(xp.shape), conv_shape,
                      lambda xp=xp, k=k: conv3x3_valid(xp, k),
                      lambda xp=xp, k=k: conv3x3_valid_reference(xp, k),
                      lambda xn=xn, wn=wn: F.conv2d(xn, wn)))
        cases.append(("conv3x3_dgrad", "conv", dt, tuple(gy.shape),
                      conv_shape,
                      lambda gy=gy, k=k: conv3x3_dgrad(gy, k),
                      lambda gy=gy, k=k: conv3x3_dgrad_reference(gy, k),
                      conv_bwd([True, False, False])))
        cases.append(("conv3x3_wgrad", "wgrad", dt, tuple(xp.shape),
                      conv_shape,
                      lambda xp=xp, gy=gy, dt=dt: conv3x3_wgrad(xp, gy, dt),
                      lambda xp=xp, gy=gy: conv3x3_wgrad_reference(xp, gy),
                      conv_bwd([False, True, False])))
        if dt == torch.bfloat16:
            conv_host_times(xp, k, gy, card_str)
        # the norm forward's wrapper and plain version: (y, mean, rstd)
        for shape in NORM_SHAPES + (NORM_BUCKET64,):
            x = (torch.randn(*shape, device="cuda", generator=g) * 3
                 + 1).to(dt)
            cases.append(("instance_norm", "norm", dt, shape, shape,
                          lambda x=x: norm_ops._forward(x, None, None, 1e-5),
                          lambda x=x: instance_norm_forward_reference(x),
                          lambda x=x: F.instance_norm(
                              x.permute(0, 3, 1, 2), eps=1e-5)))
        x = (torch.randn(BATCH, 64, 64, 256, device="cuda", generator=g) * 3
             + 1).to(dt)
        gm = torch.randn(BATCH, 256, device="cuda", generator=g)
        bt = torch.randn(BATCH, 256, device="cuda", generator=g)
        cases.append(("adain", "norm", dt, tuple(x.shape), tuple(x.shape),
                      lambda x=x, gm=gm, bt=bt: norm_ops._forward(
                          x, gm, bt, 1e-5),
                      lambda x=x, gm=gm, bt=bt:
                          instance_norm_forward_reference(x, gm, bt),
                      lambda x=x, gm=gm, bt=bt: adain_lib(x, gm, bt)))
        for shape in NORM_SHAPES:
            x = (torch.randn(*shape, device="cuda", generator=g) * 3
                 + 1).to(dt)
            dy = torch.randn(*shape, device="cuda", generator=g).to(dt)
            affine = shape == NORM_SHAPES[0]
            for gmm in ((None, gm) if affine else (None,)):
                _, mean, rstd = instance_norm_forward_reference(x, gmm, gmm)
                if dt == torch.bfloat16 and gmm is not None:
                    us = host_us(lambda: instance_norm_backward(
                        dy, x, mean, rstd, gmm))
                    log(f"[kernels] adain_bwd bf16 {shape} host time per "
                        f"call through its wrapper: {us:.6g} us "
                        f"[{card_str}]")
                # the library call's graph, built once; its backward timed
                leaves = [x.detach().clone().requires_grad_()]
                if gmm is None:
                    out = F.instance_norm(leaves[0].permute(0, 3, 1, 2),
                                          eps=1e-5)
                    dyl = dy.permute(0, 3, 1, 2)
                else:
                    leaves += [gmm.clone().requires_grad_(),
                               gmm.clone().requires_grad_()]
                    out = adain_lib(*leaves)
                    b, h, w, c = shape
                    dyl = dy.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
                cases.append((
                    "adain_bwd" if gmm is not None else "instance_norm_bwd",
                    "norm_bwd", dt, shape, shape,
                    lambda dy=dy, x=x, m=mean, r=rstd, gmm=gmm:
                        instance_norm_backward(dy, x, m, r, gmm),
                    lambda dy=dy, x=x, m=mean, r=rstd, gmm=gmm:
                        instance_norm_backward_reference(dy, x, m, r, gmm),
                    lambda out=out, leaves=leaves, dyl=dyl:
                        torch.autograd.grad(out, leaves, dyl,
                                            retain_graph=True)))
    cases += repaired_cases(g) + eval_batch_cases(g)
    for name, kind, dt, shape, work, kern, plain, library in cases:
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        # norm forward: (y, mean, rstd); backward: (dx, dgamma, dbeta)
        if isinstance(got, tuple):
            pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
        else:
            pairs = [(got, ref)]
        # each output against its own largest value; the forward's f32
        # statistics at the f32 tolerance
        rels = [tol_rel[(kind, dt)]] + [
            tol_rel[(kind, torch.float32 if kind == "norm" else dt)]] * (
                len(pairs) - 1)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
        tols = [r * b.float().abs().max().item()
                for r, (_, b) in zip(rels, pairs)]
        err = max(errs)
        ms, plain_ms, library_ms = time_turns(kern, plain, library)
        esize = 2 if dt == torch.bfloat16 else 4
        bms, bound_by = bound_ms(name, work, esize)
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        log(f"[kernels] {name} {dname} {shape}: max_abs_err "
            f"{' '.join(f'{e:.6g}' for e in errs)} (tol "
            f"{' '.join(f'{t:.6g}' for t in tols)}) kernel {ms:.6g} ms "
            f"plain {plain_ms:.6g} ms library {library_ms:.6g} ms bound "
            f"{bms:.6g} ms ({bound_by}), {100 * bms / ms:.4g}% of it "
            f"[{card_str}]")
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"{name} {dname} {shape}: max_abs_err "
                                 f"{errs} > tol {tols}")
        if name in DETERMINISTIC:
            again = kern()
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,))
                       if b is not None):
                raise AssertionError(f"{name} {dname} {shape}: two launches "
                                     f"on the same inputs differ")
            log(f"[kernels] {name} {dname} {shape}: two launches bit-equal")
        results[(name, dname, shape)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": bound_by,
            "bound_share": bms / ms}
    return results


def adain_lib(x, gm, bt):
    """The AdaIN forward's library call: F.instance_norm on x reshaped to
    (1, B*C, H, W) with the flattened per-(sample, channel) gamma and
    beta, as MUNIT's AdaptiveInstanceNorm2d computes it."""
    b, h, w, c = x.shape
    return F.instance_norm(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w),
                           weight=gm.flatten(), bias=bt.flatten(), eps=1e-5)


def eval_batch_cases(g: torch.Generator) -> list:
    """Phase 3's cases at the eval path's batch (EVAL_BATCH: phase 9's
    ``cli.eval --batch_size`` and the hook's images), in bf16 as that path
    runs them: the conv, the norm forward at its three sites and the AdaIN
    forward (the norm grid's split over the (sample, channel) groups
    changes with the batch). Same tolerances, library calls and bound as
    the main shapes."""
    dt = torch.bfloat16
    b = EVAL_BATCH
    xp = torch.randn(b, 66, 66, 256, device="cuda", generator=g).to(dt)
    k = hwio_weight(torch.randn(256, 256, 3, 3, device="cuda", generator=g)
                    / 48.0, dt)
    xn = xp.permute(0, 3, 1, 2)
    wn = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    cases = [("conv3x3", "conv", dt, tuple(xp.shape), (b, 64, 64, 256, 256),
              lambda: conv3x3_valid(xp, k),
              lambda: conv3x3_valid_reference(xp, k),
              lambda: F.conv2d(xn, wn))]
    for shape in ((b,) + s[1:] for s in NORM_SHAPES):
        x = (torch.randn(*shape, device="cuda", generator=g) * 3 + 1).to(dt)
        cases.append(("instance_norm", "norm", dt, shape, shape,
                      lambda x=x: norm_ops._forward(x, None, None, 1e-5),
                      lambda x=x: instance_norm_forward_reference(x),
                      lambda x=x: F.instance_norm(x.permute(0, 3, 1, 2),
                                                  eps=1e-5)))
    x = (torch.randn(b, 64, 64, 256, device="cuda", generator=g) * 3
         + 1).to(dt)
    gm = torch.randn(b, 256, device="cuda", generator=g)
    bt = torch.randn(b, 256, device="cuda", generator=g)
    cases.append(("adain", "norm", dt, tuple(x.shape), tuple(x.shape),
                  lambda: norm_ops._forward(x, gm, bt, 1e-5),
                  lambda: instance_norm_forward_reference(x, gm, bt),
                  lambda: adain_lib(x, gm, bt)))
    return cases


def repaired_cases(g: torch.Generator) -> list:
    """Phase 3's cases for two inputs the kernels once refused, in bf16:
    the norm backward at NORM_BWD_BATCH128 (IN and AdaIN), and the conv,
    its dgrad and its wgrad at CONV_RAGGED's C = 12, O = 20. Same
    tolerances, library calls and bound as the main shapes."""
    dt = torch.bfloat16
    cases = []
    b, h, w, c, o = CONV_RAGGED
    xp = torch.randn(b, h + 2, w + 2, c, device="cuda", generator=g).to(dt)
    k = hwio_weight(torch.randn(o, c, 3, 3, device="cuda", generator=g)
                    / (9 * c) ** 0.5, dt)
    gy = torch.randn(b, h, w, o, device="cuda", generator=g).to(dt)
    xn, gn = xp.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    wn = k.permute(3, 2, 0, 1)

    def conv_bwd(mask):
        return lambda: torch.ops.aten.convolution_backward(
            gn, xn, wn, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask)

    cases.append(("conv3x3", "conv", dt, tuple(xp.shape), CONV_RAGGED,
                  lambda: conv3x3_valid(xp, k),
                  lambda: conv3x3_valid_reference(xp, k),
                  lambda: F.conv2d(xn, wn)))
    cases.append(("conv3x3_dgrad", "conv", dt, tuple(gy.shape), CONV_RAGGED,
                  lambda: conv3x3_dgrad(gy, k),
                  lambda: conv3x3_dgrad_reference(gy, k),
                  conv_bwd([True, False, False])))
    cases.append(("conv3x3_wgrad", "wgrad", dt, tuple(xp.shape),
                  CONV_RAGGED, lambda: conv3x3_wgrad(xp, gy, dt),
                  lambda: conv3x3_wgrad_reference(xp, gy),
                  conv_bwd([False, True, False])))
    shape = NORM_BWD_BATCH128
    x = (torch.randn(*shape, device="cuda", generator=g) * 3 + 1).to(dt)
    dy = torch.randn(*shape, device="cuda", generator=g).to(dt)
    gm = torch.randn(shape[0], shape[3], device="cuda", generator=g)
    for gmm in (None, gm):
        _, mean, rstd = instance_norm_forward_reference(x, gmm, gmm)
        leaves = [x.detach().clone().requires_grad_()]
        dyl = dy.permute(0, 3, 1, 2)
        if gmm is None:
            out = F.instance_norm(leaves[0].permute(0, 3, 1, 2), eps=1e-5)
        else:
            leaves += [gmm.clone().requires_grad_(),
                       gmm.clone().requires_grad_()]
            bb, hh, ww, cc = shape
            out = F.instance_norm(
                leaves[0].permute(0, 3, 1, 2).reshape(1, bb * cc, hh, ww),
                weight=leaves[1].flatten(), bias=leaves[2].flatten(),
                eps=1e-5)
            dyl = dyl.reshape(1, bb * cc, hh, ww)
        cases.append((
            "adain_bwd" if gmm is not None else "instance_norm_bwd",
            "norm_bwd", dt, shape, shape,
            lambda m=mean, r=rstd, gmm=gmm:
                instance_norm_backward(dy, x, m, r, gmm),
            lambda m=mean, r=rstd, gmm=gmm:
                instance_norm_backward_reference(dy, x, m, r, gmm),
            lambda out=out, leaves=leaves, dyl=dyl:
                torch.autograd.grad(out, leaves, dyl, retain_graph=True)))
    return cases


COUNTERS = ((conv3x3_valid, ("launches", "grad_launches")),
            (conv3x3_dgrad, ("launches",)), (conv3x3_wgrad, ("launches",)),
            (instance_norm, ("launches", "affine_launches", "grad_launches",
                             "affine_grad_launches")),
            (instance_norm_backward, ("launches", "affine_launches")))


def reset_counts():
    for fn, names in COUNTERS:
        for name in names:
            setattr(fn, name, 0)


def counts():
    return (conv3x3_valid.launches, instance_norm.launches,
            instance_norm.affine_launches)


def check_counts(got, forwards: int, where: str):
    want = (CONV_PER_FWD * forwards, NORM_PER_FWD * forwards,
            ADAIN_PER_FWD * forwards)
    log(f"[serve] {where}: launches conv/norm/adain {got}, want {want} "
        f"for {forwards} member forwards")
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got} != {want}")


def submit_all(engine, images, seeds):
    """Submit one request per image from its own thread; return results."""
    futures = [None] * len(images)

    def go(i):
        futures[i] = engine.submit(images[i], seed=seeds[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("a submitting thread hung")
    return [f.result(timeout=300) for f in futures]


def phase_serve(card_str: str, tmp: str):
    """Phase 4: the serving slice through build_engine, at full width."""
    cfg = Config.from_dict(FLAGSHIP)
    tr = Translator(cfg, device="cuda")
    gens = tr.init_members(N_MEMBERS, seed=0)
    ckpt = os.path.join(tmp, "gen_flagship.pt")
    torch.save({f"a2b_{i}": {k: v.cpu() for k, v in g.state_dict().items()}
                for i, g in enumerate(gens)}, ckpt)
    del gens
    rng = np.random.default_rng(0)
    n_req = 2 * BATCH
    images = rng.integers(0, 256, (n_req, HW, HW, 3), dtype=np.uint8)
    seeds = [1000 + i for i in range(n_req)]

    engine = build_engine(cfg, ckpt, "0", "a2b", max_batch=BATCH,
                          max_delay_ms=200.0, warmup=True, device="cuda")
    try:
        reset_counts()
        outs = submit_all(engine, images, seeds)
        torch.cuda.synchronize()
        launches = counts()
        stats = engine.snapshot_stats()
        check_counts(launches, stats["batches"], "member 0")
        # bf16 roundings depend on the batch shape (library algorithm
        # choices, the norm kernels' split of HW), so the direct
        # reference runs at the engine's bucket: the requests must have
        # coalesced into full buckets of BATCH
        if stats["batch_size_histogram"] != {BATCH: n_req // BATCH}:
            raise AssertionError(f"engine did not coalesce into full "
                                 f"buckets: {stats}")
        zs = np.stack([engine.make_z(s) for s in seeds])
        direct = np.concatenate([engine.translator.translate_u8io(
            engine.params, images[j:j + BATCH], z=zs[j:j + BATCH])
            for j in range(0, n_req, BATCH)])
        for i, out in enumerate(outs):
            if out.shape != (HW, HW, 3) or out.dtype != np.uint8:
                raise AssertionError(f"request {i}: {out.shape} {out.dtype}")
            diff = np.abs(out.astype(np.int16) - direct[i].astype(np.int16))
            if diff.max() > 1:
                raise AssertionError(f"request {i}: engine vs direct "
                                     f"differs by {diff.max()} levels")
        single = engine.translator.translate_u8io(engine.params, images[:1],
                                                  z=zs[:1])[0]
        b1 = np.abs(single.astype(np.int16) - outs[0].astype(np.int16))
        log(f"[serve] member 0: {n_req} requests OK, each within 1 uint8 "
            f"level of a direct translate_u8io call at batch {BATCH}; the "
            f"same image at batch 1 differs by up to {b1.max()} levels "
            f"(mean {b1.mean():.4g})")
        log(f"[serve] /stats {json.dumps(stats)} [{card_str}]")

        # throughput at bucket 8: full buckets through the engine (one
        # round first, so one-off costs such as pinned-buffer allocation
        # stay out of the timed run), and the device call alone
        n_tp = 32 * BATCH
        tp_imgs = np.repeat(images[:BATCH], 32, axis=0)
        for f in [engine.submit(im, seed=0) for im in images[:BATCH]]:
            f.result(timeout=300)
        t0 = time.perf_counter()
        for f in [engine.submit(im, seed=i) for i, im in enumerate(tp_imgs)]:
            f.result(timeout=300)
        engine_ips = n_tp / (time.perf_counter() - t0)
        x8 = torch.from_numpy(images[:BATCH]).cuda()
        z8 = torch.randn(BATCH, cfg.gen.style_dim).cuda()
        ms = median_ms(lambda: engine.translator.translate_u8io_device(
            engine.params, x8, z=z8), reps=10)
        device_ips = BATCH / (float(np.median(ms)) / 1e3)
        log(f"[serve] member 0 bucket {BATCH}: engine {engine_ips:.6g} "
            f"img/s ({n_tp} requests), device call "
            f"{float(np.median(ms)):.6g} ms = {device_ips:.6g} img/s "
            f"[{card_str}]")
        log(f"[serve] /stats {json.dumps(engine.snapshot_stats())} "
            f"[{card_str}]")
    finally:
        engine.stop()

    engine = build_engine(cfg, ckpt, "all", "a2b", max_batch=BATCH,
                          max_delay_ms=200.0, warmup=True, device="cuda")
    try:
        reset_counts()
        outs = submit_all(engine, images[:4], seeds[:4])
        torch.cuda.synchronize()
        ens_launches = counts()
        stats = engine.snapshot_stats()
        check_counts(ens_launches, stats["batches"] * N_MEMBERS, "all")
        if stats["batch_size_histogram"] != {4: 1}:
            raise AssertionError(f"ensemble requests did not coalesce into "
                                 f"one bucket of 4: {stats}")
        direct = engine.translator.translate_all_u8io_device(
            engine.params, images[:4],
            np.stack([engine.make_z(s) for s in seeds[:4]])).cpu().numpy()
        for i, out in enumerate(outs):
            if out.shape != (N_MEMBERS, HW, HW, 3) or out.dtype != np.uint8:
                raise AssertionError(f"ensemble request {i}: {out.shape}")
            diff = np.abs(out.astype(np.int16)
                          - direct[:, i].astype(np.int16))
            if diff.max() > 1:
                raise AssertionError(f"ensemble request {i} differs by "
                                     f"{diff.max()} levels")
        log(f"[serve] all members: 4 requests OK, "
            f"{(N_MEMBERS, HW, HW, 3)} each; /stats {json.dumps(stats)} "
            f"[{card_str}]")
    finally:
        engine.stop()
    return ckpt, launches


def phase_accuracy(ckpt: str, card_str: str, x=None, z=None,
                   where: str = "accuracy"):
    """Phase 5: member 0, fixed z: the card's bf16 path and f32 path
    against the port on the CPU in f32 (the plain versions), on 2 random
    images, or on the batch ``x`` with its codes ``z`` (phase 9 passes the
    eval call's first batch: the kernels at its batch size).

    Tolerances in [-1, 1] output units:
      f32 on the card: max 1e-3 — same math, other summation orders
            (TF32 is off), through ~40 layers;
      bf16 on the card: mean 2e-2, max 0.25 — bf16 keeps 8 significant
            bits (~0.4% per rounding), compounded over ~40 layers."""
    from councilx_torch.ckpt.manager import load_generator_state_dicts

    cfg32 = Config.from_dict({**FLAGSHIP, "compute_dtype": "float32"})
    sd0 = load_generator_state_dicts(ckpt, cfg32)[0]
    if x is None:
        rng = np.random.default_rng(1)
        x = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
        z = rng.standard_normal((2, 8)).astype(np.float32)
    tr_cpu = Translator(cfg32, device="cpu")
    ref = tr_cpu.translate(tr_cpu.load_members([sd0])[0], x, z)[0].numpy()
    if ref.shape != (len(x), HW, HW, 3) or not np.isfinite(ref).all():
        raise AssertionError(f"CPU reference: {ref.shape}, non-finite")
    for name, cfg, tol_mean, tol_max in (
            ("f32", cfg32, 1e-3, 1e-3),
            ("bf16", Config.from_dict(FLAGSHIP), 2e-2, 0.25)):
        tr = Translator(cfg, device="cuda")
        got = tr.translate(tr.load_members([sd0])[0], x, z)[0].cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: {got.shape}, non-finite values")
        d = np.abs(got - ref)
        log(f"[{where}] card {name} vs CPU f32, member 0 at batch "
            f"{len(x)}: mean abs {d.mean():.6g} max abs {d.max():.6g} (tol "
            f"mean {tol_mean}, max {tol_max}) [{card_str}]")
        if not (d.mean() <= tol_mean and d.max() <= tol_max):
            raise AssertionError(f"card {name} path disagrees with CPU f32 "
                                 f"at batch {len(x)}")


def _finite(metrics) -> bool:
    return bool(torch.isfinite(torch.stack(
        [v.float() for v in metrics.values()])).all())


def _snapshot():
    return {f"{fn.__name__}.{name}": getattr(fn, name)
            for fn, names in COUNTERS for name in names}


def phase_train(card_str: str) -> dict:
    """Phase 6: the train step at full width (``bench.py::headline_config``)
    through ``CouncilTrainer.train_step``; returns the kernels' launch
    counts over the timed steps."""
    cfg = Config.from_dict(HEADLINE)
    trainer = CouncilTrainer(cfg, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state(seed=0)
    rng = np.random.default_rng(0)
    x_a, x_b = (torch.from_numpy(rng.uniform(-1, 1, (BATCH, HW, HW, 3))
                                 .astype(np.float32)).cuda()
                for _ in range(2))
    torch.cuda.synchronize()
    log(f"[train] init {time.perf_counter() - t0:.6g} s (council-"
        f"{N_MEMBERS}, {HW}px, batch {BATCH}, bf16, random weights, seed 0)")
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARM_STEPS):
        state, m = trainer.train_step(state, x_a, x_b)
        if not _finite(m):
            raise AssertionError(f"warm step {i}: non-finite metrics {m}")
    torch.cuda.synchronize()
    reset_counts()
    series = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, m = trainer.train_step(state, x_a, x_b)
        series.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _snapshot()
    for i, m in enumerate(series):
        if not _finite(m):
            raise AssertionError(f"timed step {i}: non-finite metrics "
                                 f"{ {k: float(v) for k, v in m.items()} }")
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] {TIMED_STEPS} steps in {seconds:.6g} s: "
        f"{BATCH * TIMED_STEPS / seconds:.6g} img/s, "
        f"{1e3 * seconds / TIMED_STEPS:.6g} ms/step; peak memory "
        f"{peak / 2 ** 30:.6g} GiB [{card_str}]")
    log(f"[train] loss_dis_adv "
        f"{[round(float(m['loss_dis_adv']), 6) for m in series]}; last "
        f"step {json.dumps({k: float(v) for k, v in series[-1].items()})} "
        f"[{card_str}]")
    # launch invariants: every kernel site ran under autograd, and every
    # forward under autograd had its backward
    steps = TIMED_STEPS * N_MEMBERS
    conv = TRAIN_CONV_PER_MEMBER * steps
    norm = TRAIN_NORM_PER_MEMBER * steps
    adain = TRAIN_ADAIN_PER_MEMBER * steps
    want = {
        "conv3x3_valid.launches": conv, "conv3x3_valid.grad_launches": conv,
        "conv3x3_dgrad.launches": conv, "conv3x3_wgrad.launches": conv,
        "instance_norm.launches": norm, "instance_norm.grad_launches": norm,
        "instance_norm.affine_launches": adain,
        "instance_norm.affine_grad_launches": adain,
        "instance_norm_backward.launches": norm,
        "instance_norm_backward.affine_launches": adain}
    log(f"[train] launches over the timed steps {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"train launches {got} != {want}")
    return got, BATCH * TIMED_STEPS / seconds


def phase_train_accuracy(card_str: str):
    """Phase 7: the first two steps of a reduced config (council-2, 64px,
    gen dim 32, n_res 2, dis dim 16 with 2 layers and 2 scales, batch 2) on
    the card against the port on the CPU in f32 (the plain versions), from
    the same weights, batch and z.

    Tolerances on every metric, relative:
      f32 (parity mode) on the card: step 1 1e-4 -- the same math on the
            same weights, sums in another order (TF32 off); step 2 1e-3 --
            its weights already differ, because Adam's first update turns
            rounding-noise gradients (the conv biases that IN/AdaIN
            removes) into moves of up to +-lr;
      bf16 on the card: 3e-2 (and 1e-3 absolute) -- each loss is a mean
            over many bf16-rounded values (8 significant bits) through ~40
            layers, so most of the rounding averages out."""
    rng = np.random.default_rng(2)
    hw = REDUCED["crop_image_height"]
    b = REDUCED["batch_size"]
    x_a, x_b = (rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
                for _ in range(2))
    cfg32 = Config.from_dict({**REDUCED, "parity_mode": True})
    cpu = CouncilTrainer(cfg32, device="cpu")
    cpu_state = cpu.init_state(seed=1)
    sds = cpu_state.state_dicts()
    zs_steps = [cpu.draw_zs(cpu_state, b) for _ in range(2)]
    ref = []
    for zs in zs_steps:
        cpu_state, m = cpu.train_step(cpu_state, x_a, x_b, zs=zs)
        ref.append({k: float(v) for k, v in m.items()})
    for name, cfg, rtols, atol in (
            ("f32", cfg32, (1e-4, 1e-3), 0.0),
            ("bf16", Config.from_dict({**REDUCED,
                                       "compute_dtype": "bfloat16"}),
             (3e-2, 3e-2), 1e-3)):
        gpu = CouncilTrainer(cfg, device="cuda")
        state = gpu.load_state(sds)
        for step, (zs, want) in enumerate(zip(zs_steps, ref)):
            state, m = gpu.train_step(state, x_a, x_b, zs=zs)
            got = {k: float(v) for k, v in m.items()}
            if set(got) != set(want):
                raise AssertionError(f"{name}: metrics {sorted(got)}")
            rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                   for k in want}
            worst = max(rel, key=rel.get)
            log(f"[train-accuracy] card {name} step {step + 1} vs CPU f32: "
                f"worst metric {worst} rel {rel[worst]:.6g} (rtol "
                f"{rtols[step]}, atol {atol}) [{card_str}]")
            for k in want:
                if abs(got[k] - want[k]) > atol + rtols[step] * abs(want[k]):
                    raise AssertionError(
                        f"card {name} step {step + 1}: {k} {got[k]} vs CPU "
                        f"{want[k]}")


def write_folders(root: str) -> None:
    """trainA/B, testA/B under root: CLI_IMAGES seeded JPEGs each, ~300x280
    (heights 296-303, widths 276-283: the loader's resize to 270 and the
    center crop always work)."""
    from PIL import Image

    rng = np.random.default_rng(8)
    for split in ("trainA", "trainB", "testA", "testB"):
        os.makedirs(os.path.join(root, split))
        for i in range(CLI_IMAGES):
            h, w = 296 + i % 8, 276 + (3 * i) % 8
            # smooth noise (JPEG-like content) plus fine grain
            base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
            img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
            img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(root, split, f"{i:04d}.jpg"), quality=90)


def _metric_steps(path: str) -> dict:
    with open(path) as f:
        return {rec["step"]: rec for rec in map(json.loads, f)}


def decode_seconds(cfg, steps: int):
    """(seconds, native): the two train loaders, started together with
    empty queues, hand over ``steps`` batches each, every one decoded
    inside the window. The train loop's prefetch queues fill while its
    first step warms up and hide the decode over a few steps; this is the
    rate the loaders sustain once the queues have drained (an upper bound
    there: no step competes for the host)."""
    from councilx_torch.data.loader import get_all_data_loaders

    train_a, train_b = get_all_data_loaders(cfg)[:2]
    t0 = time.perf_counter()
    it_a, it_b = iter(train_a), iter(train_b)
    try:
        for _ in range(steps):
            next(it_a)
            next(it_b)
    finally:
        it_a.close()
        it_b.close()
    return time.perf_counter() - t0, train_a.native and train_b.native


def phase_train_cli(card_str: str, tmp: str, step_ips: float) -> dict:
    """Phase 8: the train CLI at the headline config from image folders,
    resumed, then translate and the GUI from its snapshot. Returns the
    kernels' launch counts over the loop's steps."""
    import yaml

    from councilx_torch.cli import gui
    from councilx_torch.cli import train as train_cli
    from councilx_torch.cli import translate as translate_cli

    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    write_folders(data)
    cfg_path = os.path.join(tmp, "headline.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({**HEADLINE, **CLI_CADENCE, "data_root": data}, f)
    log(f"[train-cli] {4 * CLI_IMAGES} JPEGs written in "
        f"{time.perf_counter() - t0:.6g} s")
    from councilx_torch.config import load_config

    cfg = load_config(cfg_path)
    # two epochs of each train folder
    dsteps = 2 * CLI_IMAGES // cfg.batch_size
    dsec, dnative = decode_seconds(cfg, dsteps)
    log(f"[train-cli] decode alone: both train loaders ("
        f"{'native C++ (cxloader)' if dnative else 'PIL threads'}, "
        f"{cfg.data.num_workers} threads each, batch {cfg.batch_size}) from "
        f"empty queues, {dsteps} batches each in {dsec:.6g} s: "
        f"{1e3 * dsec / dsteps:.6g} ms per step, "
        f"{dsteps * cfg.batch_size / dsec:.6g} img/s, beside phase 6's "
        f"train_step {1e3 * cfg.batch_size / step_ips:.6g} ms per step "
        f"({step_ips:.6g} img/s) [{card_str}]")
    out = os.path.join(tmp, "runs")
    args = ["--config", cfg_path, "--output_path", out]
    reset_counts()
    t0 = time.perf_counter()
    first = train_cli.main(args + ["--max_steps", str(CLI_STEPS)])
    resumed = train_cli.main(args + ["--resume", "--max_steps",
                                     str(CLI_RESUME_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _snapshot()
    end = CLI_STEPS + CLI_RESUME_STEPS
    if (first["step"], resumed["start_step"], resumed["step"]) != (
            CLI_STEPS, CLI_STEPS, end):
        raise AssertionError(f"train CLI steps: {first} then {resumed}")
    run = os.path.join(out, "headline")
    recs = _metric_steps(os.path.join(run, "metrics.jsonl"))
    want_steps = list(range(CLI_CADENCE["log_iter"], end + 1,
                            CLI_CADENCE["log_iter"]))
    if sorted(recs) != want_steps:
        raise AssertionError(f"metrics.jsonl steps {sorted(recs)} != "
                             f"{want_steps}")
    for step, rec in recs.items():
        vals = [v for k, v in rec.items() if k not in ("step", "time")]
        if not np.isfinite(vals).all():
            raise AssertionError(f"step {step}: non-finite metrics {rec}")
    log(f"[train-cli] {CLI_STEPS} steps, then --resume from "
        f"{resumed['start_step']} to {resumed['step']}, in {seconds:.6g} s "
        f"(two trainer inits and the first steps' setup included); "
        f"metrics.jsonl finite at steps {sorted(recs)}")
    log(f"[train-cli] loop {first['images_per_sec']:.6g} img/s over steps "
        f"{CLI_STEPS - CLI_CADENCE['log_iter'] + 1}-{CLI_STEPS} (step 3's "
        f"snapshot writing behind them) and {resumed['images_per_sec']:.6g} "
        f"img/s over the resumed steps {CLI_STEPS + 1}-{end} (no write), "
        f"loader, augment and step, beside phase 6's train_step "
        f"{step_ips:.6g} img/s on device-resident inputs; the loop waited "
        f"{first['stage_wait_seconds']:.6g} s + "
        f"{resumed['stage_wait_seconds']:.6g} s in all for staged batches "
        f"[{card_str}]")
    log(f"[train-cli] snapshot {resumed['snapshot_bytes']} bytes "
        f"({resumed['snapshot_bytes'] / 2 ** 30:.6g} GiB: 12 networks' "
        f"parameters and two Adam moments); the async saves' "
        f"device-to-host copies held the loop "
        f"{' s, '.join(f'{t:.6g}' for t in first['snapshot_copy_seconds'])}"
        f" s, their waits for the previous write "
        f"{first['snapshot_write_wait_seconds']:.6g} s in all; the final "
        f"synchronous save (copy and write) "
        f"{first['final_save_seconds']:.6g} s (steps 1-{CLI_STEPS}: none, "
        f"step {CLI_STEPS} was saved) and "
        f"{resumed['final_save_seconds']:.6g} s (step {end}) [{card_str}]")
    log(f"[train-cli] decode path: "
        f"{'native C++ (cxloader)' if first['native'] else 'PIL threads'}")

    # launch invariants over the loop's steps: every step's kernel sites
    # ran under autograd with their backward; the rest are the sample
    # sheets' member forwards (no grad)
    steps = end * N_MEMBERS
    conv = TRAIN_CONV_PER_MEMBER * steps
    norm = TRAIN_NORM_PER_MEMBER * steps
    adain = TRAIN_ADAIN_PER_MEMBER * steps
    # per image_save_iter a test and a train sheet, per image_display_iter
    # the "current" one: each sheet one forward of every member
    sheets = sum(2 * (s % CLI_CADENCE["image_save_iter"] == 0)
                 + (s % CLI_CADENCE["image_display_iter"] == 0)
                 for s in range(1, end + 1))
    fwd = sheets * N_MEMBERS
    want = {
        "conv3x3_valid.launches": conv + CONV_PER_FWD * fwd,
        "conv3x3_valid.grad_launches": conv,
        "conv3x3_dgrad.launches": conv, "conv3x3_wgrad.launches": conv,
        "instance_norm.launches": norm + NORM_PER_FWD * fwd,
        "instance_norm.grad_launches": norm,
        "instance_norm.affine_launches": adain + ADAIN_PER_FWD * fwd,
        "instance_norm.affine_grad_launches": adain,
        "instance_norm_backward.launches": norm,
        "instance_norm_backward.affine_launches": adain}
    log(f"[train-cli] launches over the loop's {end} steps and "
        f"{fwd} sample-sheet member forwards {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"train-cli launches {got} != {want}")

    snap = os.path.join(run, "checkpoints", f"step_{end:08d}")
    trans_out = os.path.join(tmp, "translated")
    t0 = time.perf_counter()
    n = translate_cli.main(["--config", cfg_path, "--checkpoint", snap,
                            "--input_folder", os.path.join(data, "testA"),
                            "--output_folder", trans_out, "--member", "all"])
    files = sorted(os.listdir(trans_out))
    want_files = sorted(f"{i:04d}_m{m}.jpg" for i in range(CLI_IMAGES)
                        for m in range(N_MEMBERS))
    if n != CLI_IMAGES or files != want_files:
        raise AssertionError(f"translate wrote {len(files)} files for {n} "
                             f"images")
    log(f"[train-cli] translate --member all: {len(files)} files from "
        f"{snap} in {time.perf_counter() - t0:.6g} s")

    srv = gui.make_server(cfg, snap,
                          os.path.join(data, "testA"), port=0,
                          host="127.0.0.1")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=120)
        conn.request("GET", "/translate?image=0000.jpg&member=all&seed=3")
        resp = conn.getresponse()
        panels = json.loads(resp.read())["panels"]
        conn.request("GET", panels[1]["url"])
        img = conn.getresponse().read()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    # input, 4 members, 4 masks
    if resp.status != 200 or len(panels) != 1 + 2 * N_MEMBERS or \
            not img.startswith(b"\x89PNG"):
        raise AssertionError(f"gui render: {resp.status} {panels}")
    log(f"[train-cli] gui: one render of all {N_MEMBERS} members from "
        f"{snap}: {[p['title'] for p in panels]}")
    return got


def eval_launches(images: int, batch: int, members: int) -> dict:
    """Every counter over one ``cli.eval --member all`` call: each batch
    (the tail padded to ``batch``) is one forward of every member, under
    no gradient."""
    fwd = members * -(-images // batch)
    want = {name: 0 for name in _snapshot()}
    want.update({"conv3x3_valid.launches": CONV_PER_FWD * fwd,
                 "instance_norm.launches": NORM_PER_FWD * fwd,
                 "instance_norm.affine_launches": ADAIN_PER_FWD * fwd})
    return want


def check_eval(out: dict, launches: dict, images: int, batch: int,
               members: int) -> None:
    """Raise unless a ``cli.eval --member all`` result is whole: one
    finite FID per member, the best member their argmin, every image
    translated, and the kernels launched exactly as ``eval_launches``
    says."""
    fids = out["fid_per_member"]
    if len(fids) != members or not np.isfinite(fids).all():
        raise AssertionError(f"eval: per-member FID {fids}")
    if out["best_member"] != int(np.argmin(fids)) or \
            out["fid"] != fids[out["best_member"]]:
        raise AssertionError(f"eval: best member {out['best_member']} is "
                             f"not the argmin of {fids}")
    if out["n_translated"] != images:
        raise AssertionError(f"eval: {out['n_translated']} images "
                             f"translated, want {images}")
    want = eval_launches(images, batch, members)
    if launches != want:
        raise AssertionError(f"eval launches {launches} != {want}")


def phase_eval(card_str: str, tmp: str, ckpt: str) -> dict:
    """Phase 9: the eval CLI on phase 4's checkpoint, the Inception
    features card against CPU, and the in-training FID hook. Returns the
    kernels' launch counts over the eval call."""
    import warnings

    import yaml

    from councilx_torch.ckpt.manager import load_generator_state_dicts
    from councilx_torch.cli import eval as eval_cli
    from councilx_torch.config import load_config
    from councilx_torch.data.dataset import ImageFolderDataset
    from councilx_torch.data.loader import get_all_data_loaders
    from councilx_torch.data.ondevice import normalize_batch
    from councilx_torch.eval.features import (extract_features,
                                              iter_image_batches,
                                              u8_to_inception_inputs)
    from councilx_torch.eval.hook import TrainEvalHook
    from councilx_torch.eval.inception import (InceptionV3Features,
                                               make_inception)
    from councilx_torch.eval.metrics import fid_from_features

    data = os.path.join(tmp, "data")
    write_folders(data)
    cfg_path = os.path.join(tmp, "flagship.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(FLAGSHIP, f)
    test_a, test_b = (os.path.join(data, s) for s in ("testA", "testB"))

    reset_counts()
    t0 = time.perf_counter()
    out = eval_cli.main(["--config", cfg_path, "--checkpoint", ckpt,
                         "--input_folder", test_a, "--target_folder", test_b,
                         "--member", "all", "--kid", "--allow-random",
                         "--batch_size", str(EVAL_BATCH)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = _snapshot()
    log(f"[eval] cli.eval --member all: FID per member "
        f"{out['fid_per_member']}, best {out['best_member']}, "
        f"{out['n_translated']} translated, {out['n_target']} targets, in "
        f"{seconds:.6g} s; launches {json.dumps(got)} [{card_str}]")
    check_eval(out, got, CLI_IMAGES, EVAL_BATCH, N_MEMBERS)

    # the eval path's layers, timed apart: the council's translate of one
    # batch on the card, the Inception features on the card, the PIL
    # preprocessing and the FID on the host
    cfg = load_config(cfg_path)
    tr = Translator(cfg, device="cuda")
    gens = tr.load_members(load_generator_state_dicts(ckpt, cfg))
    ds = ImageFolderDataset(test_a, new_size=cfg.data.new_size,
                            crop=cfg.data.crop_image_height)
    # the eval call's first batch and its codes (cli.eval draws them from
    # a torch.Generator seeded with --seed, 1 by default)
    x = normalize_batch(torch.from_numpy(
        np.stack([ds[i] for i in range(EVAL_BATCH)])))
    z = torch.randn((N_MEMBERS, EVAL_BATCH, cfg.gen.style_dim),
                    generator=torch.Generator().manual_seed(1))
    phase_accuracy(ckpt, card_str, x=x, z=z[0], where="eval")
    ms = median_ms(lambda: tr.translate_all_members(gens, x, z=z), reps=5)
    tr_ms = float(np.median(ms))
    u8 = _u8_from_unit(tr.translate_all_members(gens, x, z=z)[0][0]
                       ).cpu().numpy()
    t0 = time.perf_counter()
    inputs = u8_to_inception_inputs(u8)
    pil_ms = 1e3 * (time.perf_counter() - t0) / EVAL_BATCH
    log(f"[eval] translate, every member, batch {EVAL_BATCH}: "
        f"{tr_ms:.6g} ms per call (the upload included), "
        f"{N_MEMBERS * EVAL_BATCH / (tr_ms / 1e3):.6g} member img/s "
        f"[{card_str}]")
    log(f"[eval] PIL preprocessing (resize {HW} -> 299, normalize) on the "
        f"host: {pil_ms:.6g} ms per image [{card_str}]")

    model = make_inception("random", "cuda")
    batch = torch.from_numpy(np.concatenate(
        [inputs, inputs])[:EVAL_FEATURE_BATCH]).cuda()
    ms = median_ms(lambda: model(batch), reps=5)
    inc_ms = float(np.median(ms))
    log(f"[eval] Inception features (f32, TF32 off), batch "
        f"{EVAL_FEATURE_BATCH} on the card: {inc_ms:.6g} ms, "
        f"{EVAL_FEATURE_BATCH / (inc_ms / 1e3):.6g} img/s [{card_str}]")

    # card against CPU on the same 4 images; TF32 on around the call, so
    # the module must switch it off itself
    cpu = InceptionV3Features(device="cpu")
    cpu.load_state_dict(model.state_dict())
    target = next(iter_image_batches(test_b, EVAL_CPU_IMAGES))
    n = EVAL_CPU_IMAGES
    feats = {}
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for name, m in (("card", model), ("cpu", cpu)):
            feats[name] = (extract_features(m, [inputs[:n]]),
                           extract_features(m, [target]))
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
    ref = np.concatenate(feats["cpu"])
    rel = float(np.abs(np.concatenate(feats["card"]) - ref).max()
                / np.abs(ref).max())
    t0 = time.perf_counter()
    fid_card = fid_from_features(*feats["card"])
    fid_s = time.perf_counter() - t0
    fid_cpu = fid_from_features(*feats["cpu"])
    fid_rel = abs(fid_card - fid_cpu) / abs(fid_cpu)
    log(f"[eval] Inception features card vs CPU, {n} translated + {n} "
        f"target images: max |diff| / max |CPU| = {rel:.6g} (tol 1e-4); "
        f"FID card {fid_card!r}, CPU {fid_cpu!r}, relative difference "
        f"{fid_rel:.6g} (tol 1e-4) [{card_str}]")
    log(f"[eval] FID on the host (float64, 2048x2048 scipy sqrtm): "
        f"{fid_s:.6g} s per call [{card_str}]")
    if not (rel <= 1e-4 and fid_rel <= 1e-4):
        raise AssertionError(f"Inception on the card disagrees with the "
                             f"CPU: {rel}, FID {fid_card} vs {fid_cpu}")
    del model, cpu, gens, tr

    # the in-training hook on a headline-config trainer; 256px frames
    # (270 would not survive two stride-2 downsamples and back)
    hcfg = Config.from_dict({**HEADLINE, "new_size": 256, "data_root": data,
                             "eval_iter": 1, "eval_member": "all",
                             "eval_inception_weights": "random",
                             "eval_max_images": EVAL_HOOK_IMAGES})
    trainer = CouncilTrainer(hcfg, device="cuda")
    state = trainer.init_state(0)
    loaders = get_all_data_loaders(hcfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hook = TrainEvalHook(hcfg, trainer, loaders[2], loaders[3])
    before = state.generator.get_state().clone()
    t0 = time.perf_counter()
    first = hook(trainer, state)
    hook_s = time.perf_counter() - t0
    log(f"[eval] hook, {EVAL_HOOK_IMAGES} images, every member: {first}; "
        f"{hook_s:.6g} s per call ({len(caught)} warning(s): "
        f"{[str(w.message)[:60] for w in caught]}) [{card_str}]")
    if len(first) != N_MEMBERS + 1 or \
            not np.isfinite(list(first.values())).all():
        raise AssertionError(f"hook: {first}")
    # the same state twice: the same features (and so the same FIDs)
    again = [hook.features(trainer, state)["a2b"] for _ in range(2)]
    if not all(np.array_equal(u, v) for u, v in zip(*again, strict=True)):
        raise AssertionError("hook: two calls on one state differ")
    if not torch.equal(state.generator.get_state(), before):
        raise AssertionError("hook: the training z stream moved")
    log(f"[eval] hook: two more translate + feature passes on the same "
        f"state bit-equal, the training z stream untouched [{card_str}]")
    return got


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_str = card()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_cuda_libraries(CUDA_SOURCES)
    log(f"[build] {time.perf_counter() - t0:.6g} s "
        f"{json.dumps(_build.build_seconds)}")

    g = torch.Generator(device="cuda").manual_seed(0)
    kres = phase_kernels(g, card_str)

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        ckpt, _ = phase_serve(card_str, tmp)
        phase_accuracy(ckpt, card_str)
        phase_eval(card_str, tmp, ckpt)
    launches, step_ips = phase_train(card_str)
    phase_train_accuracy(card_str)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cli_launches = phase_train_cli(card_str, tmp, step_ips)

    norm_l = launches["instance_norm.launches"]
    adain_l = launches["instance_norm.affine_launches"]
    bwd_l = launches["instance_norm_backward.launches"]
    adain_bwd_l = launches["instance_norm_backward.affine_launches"]
    conv_shape = (BATCH, 66, 66, 256)
    main_shape = (BATCH, 64, 64, 256)
    norm_src = "councilx_torch/csrc/instance_norm_fwd.cu"
    norm_bwd_src = "councilx_torch/csrc/instance_norm_bwd.cu"
    entries = [
        ("conv3x3", "cuda", "councilx_torch/csrc/conv3x3.cu",
         "councilx/ops/pallas_conv.py:82",
         launches["conv3x3_valid.launches"],
         kres[("conv3x3", "bf16", conv_shape)]),
        ("conv3x3_dgrad", "cuda", "councilx_torch/csrc/conv3x3.cu",
         "councilx/ops/pallas_conv.py:279",
         launches["conv3x3_dgrad.launches"],
         kres[("conv3x3_dgrad", "bf16", main_shape)]),
        ("conv3x3_wgrad", "cuda", "councilx_torch/csrc/conv3x3_wgrad.cu",
         "councilx/ops/pallas_conv.py:178",
         launches["conv3x3_wgrad.launches"],
         kres[("conv3x3_wgrad", "bf16", conv_shape)]),
        ("instance_norm", "cuda", norm_src,
         "councilx/ops/pallas_norm.py:56", norm_l - adain_l,
         kres[("instance_norm", "bf16", main_shape)]),
        ("adain", "cuda", norm_src, "councilx/ops/pallas_norm.py:67",
         adain_l, kres[("adain", "bf16", main_shape)]),
        ("instance_norm_bwd", "cuda", norm_bwd_src,
         "councilx/ops/pallas_norm.py:121", bwd_l - adain_bwd_l,
         kres[("instance_norm_bwd", "bf16", main_shape)]),
        ("adain_bwd", "cuda", norm_bwd_src,
         "councilx/ops/pallas_norm.py:132", adain_bwd_l,
         kres[("adain_bwd", "bf16", main_shape)]),
    ]
    for e in entries:
        if e[4] < 1:
            raise AssertionError(f"{e[0]} was not launched on the path")
    cli_norm = cli_launches["instance_norm.launches"]
    cli_adain = cli_launches["instance_norm.affine_launches"]
    cli_bwd = cli_launches["instance_norm_backward.launches"]
    cli_adain_bwd = cli_launches["instance_norm_backward.affine_launches"]
    for name, n in (("conv3x3", cli_launches["conv3x3_valid.launches"]),
                    ("conv3x3_dgrad", cli_launches["conv3x3_dgrad.launches"]),
                    ("conv3x3_wgrad", cli_launches["conv3x3_wgrad.launches"]),
                    ("instance_norm", cli_norm - cli_adain),
                    ("adain", cli_adain),
                    ("instance_norm_bwd", cli_bwd - cli_adain_bwd),
                    ("adain_bwd", cli_adain_bwd)):
        if n < 1:
            raise AssertionError(f"{name} was not launched on the train "
                                 f"CLI's path")
    log(card_str)
    log(json.dumps({"kernels": [
        {"name": n, "route": r, "source": s, "replaces": rep,
         "launches": lc, **m} for n, r, s, rep, lc, m in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
