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
   ``.pt``, loaded through ``councilx_torch.cli.serve.build_engine`` (on
   its default route: each bucket a captured CUDA graph), concurrent uint8
   requests from threads, results checked against direct ``Translator``
   calls; the kernels' launches counted from before the engine's warm-up
   (one eager run and one capture per bucket; the requests replay) and
   every batch a replay; then the council ensemble (``member="all"``);
5. accuracy of the serving path: the card's bf16 and f32 kernel paths
   against the port on the CPU in f32, which uses the plain versions;
6. the train step at full width (``bench.py::headline_config``: council-4,
   256px, batch 8, bf16, focus mask, a2b) through
   ``CouncilTrainer.train_step``: 2 warm steps, 10 timed steps, every
   metric finite, img/s and peak memory, and the launch counts of the
   forward and backward kernels checked against each other, P1 and P1'
   (the reflect pad and its fold) at ``TRAIN_PAD_PER_MEMBER`` and
   ``TRAIN_FOLD_PER_MEMBER`` a member and step, as every phase below
   that counts launches holds P1 to the pads of its path;
7. accuracy of the training path: a reduced config's first two steps on
   the card (f32 parity mode, then bf16) against the port on the CPU from
   the same weights, batch and z;
8. train-cli: the user's path at the same width: seeded JPEG folders
   (trainA/B, testA/B, 32 images each, ~300x280) under ``build/``,
   ``python -m councilx_torch.cli.train``'s ``main`` for 6 steps (log
   every 2, sample sheets and async snapshots every 3), then ``--resume``
   for 2 more: resumed at 6, ended at 8, finite metrics logged at steps 2,
   4, 6 and 8, both runs on the captured step, the launch invariants over
   the loop's eager and captured steps, every kernel launched, and (cuDNN
   deterministic for the loop's runs) the resumed run bit for bit an
   uninterrupted 8-step run's snapshot and metric log; then
   ``cli.translate --member all`` on testA and one ``cli.gui`` render
   (captured) from the step-8 snapshot. Prints the loop's img/s
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

10. quant (run after phase 9, in its directory): W8A8 int8 serving at the
   same width. For each ``quant_scope`` ("resblocks": the 16 resblock convs;
   "heavy": also the two downsamples and the two upsample phase convs),
   ``python -m councilx_torch.tools.calibrate_quant``'s ``main`` calibrates
   member 0 of phase 4's checkpoint over phase 9's seeded testA; then
   ``build_engine`` serves ``--quant w8a8`` and ``--quant w8a8_static
   --calibration``: concurrent requests in full buckets, each within 1
   uint8 level of a direct call at the same bucket, the launches per member
   forward (Q1 16 or 20, Q2 as many, one launch per conv in either mode, K1
   at none of them, P1 at the unquantized convs' pads, the norms as in
   phase 4), engine and device-call img/s
   beside phase 4's unquantized ones; member 0 on the card in f32 and bf16
   against the CPU port in f32 with the same quantization
   (:func:`quant_accuracy`: every quantized block on the CPU block's
   input, the first quantized conv's codes, and the output beside the
   CPU's own sensitivity to a one-ulp input change); and
   ``councilx_torch.tools.quant_quality``'s ``compare`` against the
   unquantized bf16 path, held to the JAX package's bar.
11. multi-gpu (``[multi-gpu]``, last): the ``councilx_torch.parallel``
   layouts, each on its captured route (``compile_step``; one graph per
   device) beside its eager one. In a real NCCL process group of one rank
   on ``cuda:0`` (``file://`` store under ``build/``), ``CouncilTrainer``
   takes 6 eager headline steps (cuDNN in its deterministic mode for the
   phase); ``DataParallelTrainer`` and ``CouncilShardTrainer`` (D = 1,
   K = 1) each take 6 eager steps and, from the same weights, batch and z,
   2 eager calls and 4 replays of ``compile_step`` with an eager sample
   and snapshot between two replays (the loop's collectives on the
   communicators the graphs use): every parameter, buffer, Adam moment,
   metric, sample and snapshot bit for bit ``CouncilTrainer``'s, with
   phase 6's launch invariants over the eager calls and the capture; ms
   per step on both routes, CUDA API calls per captured step (profiled as
   in ``[graphs]``), peak memory and capture seconds. Then the flagship
   serving model over several devices, each layout bit-equal to the
   one-device calls at the same per-shard bucket, its captured call (one
   graph per device) bit-equal to its eager call on two inputs with the
   first result unchanged by the second call, both calls profiled, and
   its engine's img/s on both routes: ``ShardedTranslator`` at D = 2 in
   ``quant: none`` and ``w8a8_static`` (Q1 and Q2 launched on this path),
   ``MemberShardedTranslator`` at K = 2 and K = 4; over distinct cards
   where the machine has them, else over ``cuda:0`` named D or K times.
   With 2 or more cards, ``MULTI_LAYOUTS`` (D = 2, K = 2; with 4 cards
   also D = 2 x K = 2 and K = 4) run as spawned NCCL ranks: 2 eager
   headline steps against the one-process step on ``cuda:0`` at the CPU
   tests' data-parallel tolerance, then the compiled step bit-equal to 6
   eager steps on every rank, img/s on both routes beside the world-1
   step's; K = 2 also runs ``train.loop`` on the compiled step with
   sample sheets and snapshots between replays. The ``[multi-gpu]`` lines
   name the trainers and layouts run captured and the ones this machine
   has too few cards for, and the phase's seconds.
12. complete (``[complete]``, run after phase 8, in its directory, before
   phase 11): the JAX package's last features (:func:`phase_complete`).
   (a) ``remat_stages``: 2 headline steps bit-equal to the plain step's
   from the same weights, batch and z (cuDNN deterministic), with the
   recompute's launch invariant (every forward launch twice, P1 again
   at the stages' pads, every backward once:
   :func:`remat_stage_launches`), then 2 warm and 5 timed steps of each:
   ms per step and peak memory, which must fall; (b) ``vgg_w:
   1`` with a seeded random VGG16 ``.npz`` under ``build/``: 2 warm and 5
   timed steps, finite metrics, ``loss_gen_vgg_a2b`` > 0, ms per step and
   peak memory beside the plain step's, the VGG loss's own device ms; (c)
   phase 7 with both options; (d) ``councilx_torch.tools.export_pt`` on
   phase 8's step-8 snapshot: the three reference ``.pt`` files, and member
   0 served through ``build_engine`` from the exported ``gen_*.pt``
   bit-equal to it served from the snapshot at bucket 8; (e) ``MsImageDis``
   with ``norm`` ``sn`` and ``bn`` at the headline width on the card
   against the CPU module: logits in f32 and bf16, ``u`` and the running
   statistics after a training-mode forward.
14. graphs (``[graphs]``, run after phase 13): the port's compiled
   executables (``councilx_torch/utils/graphs.py``), cuDNN deterministic,
   every replay bit-equal to the eager call (:func:`phase_graphs`). The
   flagship serving model's member 0 captured at every bucket of the
   engine's ladder, all members and the float32 wire at bucket 8, the
   GUI's two calls at one image (images and masks), and W8A8 per image
   and static in both scopes at every bucket, each replay
   on two inputs; bucket 8's eager and captured device calls side by side
   (wall, enqueue and kernel ms, device ops and CUDA API launch calls per
   call, device busy share: :func:`route_profile`) and host to host. The
   headline step: 2 eager steps (one ``train_step``, then the compiled
   step's eager warm-up call) and 10 replays of
   ``CouncilTrainer.compile_step`` bit-equal to 12 eager steps in every
   metric, parameter and Adam moment, the launches of its eager calls and
   capture, its snapshot at step 6 restored into a new trainer and
   compiled again bit-equal at step 12, both routes profiled, peak memory
   and capture seconds; then ``GRAPH_TRAIN``: scheduled loss weights with
   the council gate opening during the replays, ``every_kth`` with k = 2
   (two graphs), ``remat_stages``; and ``vgg_w: 1`` (random VGG16
   weights) for its peak memory under graphs.
13. engines (``[engines]``, run after phase 7): the JAX generator's conv
   engines at full width (:func:`phase_engines`). Member 0 of the flagship
   model at bucket 8 under ``ENGINE_SERVE`` (the reference route, the JAX
   defaults, ``upsample_engine`` phase and ln_fused, the defaults with
   ``resblock_fuse_pad``): bf16 within phase 5's tolerances of the card's
   reference route at the same bucket and of the CPU f32 Translator of the
   same setting on 2 images; K1/norm/AdaIN/P1 launches per forward; wall
   ms per call, kernel ms under the profiler. The headline step under
   ``ENGINE_TRAIN`` (the reference route, the defaults, phase +
   resblock_fuse_pad): ms per step over 10 after 2, kernel ms, launches
   (K1 more by the phase convs, P1 and P1' per ``ENGINE_TRAIN_PADS``),
   peak memory; then phase 7's
   reduced config in f32 outside parity mode under the last of them, card
   against CPU at phase 7's f32 tolerances. Every other phase runs the JAX
   defaults (phase_fused 7x7 convs, the dilated upsample).

Phase 3 also holds two inputs the kernels once refused: the norm backward
at batch 128 (more groups than one cooperative launch holds: its plain
launch) and the conv, dgrad and wgrad at C = 12, O = 20 (channels padded to
multiples of 8 around the same kernels); the eval path's kernels at
its batch of 16 (the conv, the norm forward at its three sites, AdaIN);
K1, K1' and K2 at the conv engines' shapes (:func:`engine_conv_cases`: the
two upsample phase convs, and the resblock conv at a zero pad of 1);
and the W8A8 kernels at phase 10's five conv sites (:func:`quant_cases`):
Q1 (int8 conv) bit-equal in its int32 accumulator and its bf16 (and, at
the resblock site, f32) output, Q2 (activation quantize) bit-equal in its
codes and scales, static and per image, beside K1 and cuDNN in bf16 and
``torch._int_mm`` on the unfolded int8 matrices, with each wrapper's host
time per call; and both at ragged shapes (``QUANT_RAGGED``); and P1 and
P1' (the reflect pad and its fold, :func:`pad_cases`) at ``PAD_SITES``,
P1 bit-equal to the index gather, beside the gather and its
``index_put_`` backward.

The line before the last is one JSON object describing every kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

import copy
import faulthandler
import json
import os
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

import torch.distributed as dist
import torch.multiprocessing as mp

from councilx_torch.ckpt.torch_convert import port_quant_stats_to_tree
from councilx_torch.cli.serve import build_engine
from councilx_torch.config import Config
from councilx_torch.inference.server import BatchingEngine
from councilx_torch.inference.translate import (MemberShardedTranslator,
                                                ShardedTranslator,
                                                Translator, _u8_from_unit)
from councilx_torch.nn.blocks import init_parameters
from councilx_torch.nn.discriminator import MsImageDis
from councilx_torch.nn.vgg import (compute_vgg_loss, init_random_vgg,
                                   save_vgg_npz, vgg_target_features)
from councilx_torch.ops import _build
from councilx_torch.ops import conv3x3 as conv_ops
from councilx_torch.ops import instance_norm as norm_ops
from councilx_torch.ops import pad as pad_ops
from councilx_torch.ops.pad import pad_fold, pad_nhwc
from councilx_torch.ops.conv3x3 import (conv3x3_dgrad,
                                        conv3x3_dgrad_reference,
                                        conv3x3_same_zero,
                                        conv3x3_same_zero_reference,
                                        conv3x3_valid, conv3x3_valid_reference,
                                        conv3x3_wgrad, conv3x3_wgrad_reference,
                                        hwio_weight)
from councilx_torch.ops.instance_norm import (
    instance_norm, instance_norm_backward, instance_norm_backward_reference,
    instance_norm_forward_reference)
from councilx_torch.ops.quant import (conv_int8, conv_int8_reference,
                                      quantize_act, quantize_act_reference,
                                      quantize_weights)
from councilx_torch.parallel import multihost
from councilx_torch.parallel.council_shard import CouncilShardTrainer
from councilx_torch.parallel.mesh import (DataParallelTrainer,
                                          make_member_mesh, make_mesh)
from councilx_torch.tools import export_pt
from councilx_torch.tools.calibrate_quant import calibrate
from councilx_torch.train import loop as train_loop
from councilx_torch.train.loop import make_trainer
from councilx_torch.train.trainer import GROUPS, CouncilTrainer, group_params

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
# P1 launches per member forward: the 7x7s' (phase-packed) first and last
# convs, the two 4x4 stride-2 convs, the 16 resblock convs, and 4 border
# strips per dilated upsample conv (counted on the CPU by
# tests/test_torch_chip_smoke.py, as are the pad counts below)
PAD_PER_FWD = 28
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
# P1 and P1' launches per member and headline train step, generators and
# discriminators together; P1' at every P1 whose input takes a gradient
TRAIN_PAD_PER_MEMBER = 122
TRAIN_FOLD_PER_MEMBER = 111
# P1 launches per member and step that remat_stages runs again: the pads
# inside the checkpointed stages, recomputed in the backward
REMAT_PAD_PER_MEMBER = 56
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


# phase 11: the spawned NCCL layouts (name, ranks, council_parallel), run
# where the machine has the ranks' cards; their steps and tolerances (the
# CPU tests' data-parallel ones: tests/test_torch_parallel_train.py)
MULTI_LAYOUTS = (("D=2", 2, 1), ("K=2", 2, 2), ("D=2xK=2", 4, 2),
                 ("K=4", 4, 4))
MULTI_STEPS = 2
# phase 11's steps after the MULTI_STEPS eager ones (the compiled route's
# replays; the eager route's timed steps)
MULTI_TIMED = 4
MULTI_RTOL, MULTI_ATOL, MULTI_PARAM_TOL = 2e-3, 1e-4, 5e-4
# the K=2 layout's train loop on the compiled step: sample sheets and
# snapshots (collectives of the council shards) between replays
LOOP_STEPS = 4
LOOP_CADENCE = {"log_iter": 1, "image_save_iter": 2, "image_display_iter": 2,
                "snapshot_save_iter": 2}
# a spawned rank's time limit, its layout's steps, captures and loop
# included (a minute or two when nothing hangs)
SPAWN_LIMIT_S = 300
# phase 11's serving layouts: (name, data shards, member shards)
SERVE_LAYOUTS = (("ShardedTranslator D=2", 2, 1),
                 ("MemberShardedTranslator K=2", 1, 2),
                 ("MemberShardedTranslator K=4", 1, 4))

# every CUDA source of councilx_torch/csrc, built in phase 2
CUDA_SOURCES = ("conv3x3", "conv3x3_wgrad", "instance_norm_fwd",
                "instance_norm_bwd", "quant_act", "conv_int8", "pad_nhwc")
# kernels whose two launches on the same inputs must be bit-equal
DETERMINISTIC = ("conv3x3_wgrad", "conv3x3_wgrad_pad1", "instance_norm",
                 "adain", "instance_norm_bwd", "adain_bwd", "pad_fold")
# phase 3's pad kernels (P1, P1'), reflect, bf16: x (B, H, W, C) and p of
# the resblock site and of the final 7x7 at serving's bucket 64, of the
# resblock site at bucket 8, and of the image at the discriminator's first
# conv
PAD_SITES = (((64, 64, 64, 256), 1), ((64, 256, 256, 64), 3),
             ((BATCH, 64, 64, 256), 1), ((BATCH, 256, 256, 3), 1))
# phase 3's K1/K1'/K2 at the conv engines' shapes, (B, H, W, C, O) of the
# forward conv: the upsample engines' phase conv (3x3 to 4x the block's
# outputs on the pre-upsample input replicate-padded by 1), and the
# resblock conv at a zero pad of 1 (resblock_fuse_pad's strips interior)
PHASE_CONV_SITES = {"up1": (BATCH, 64, 64, 256, 512),
                    "up2": (BATCH, 128, 128, 128, 256)}
PAD1_SITE = (BATCH, 64, 64, 256, 256)
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

# phase 10: the W8A8 convs at full width, bucket 8, bf16 compute. Per
# site: the unpadded block input (B, H, W, C), its pad and pad type, the
# kernel size, stride and output channels; Q1 reads it padded (the heavy
# upsample sites run the 3x3 phase conv to 4x the block's outputs on the
# replicate-padded pre-upsample input)
QUANT_SITES = {
    "resblock": ((BATCH, 64, 64, 256), 1, "reflect", 3, 1, 256),
    "down1": ((BATCH, 256, 256, 64), 1, "reflect", 4, 2, 128),
    "down2": ((BATCH, 128, 128, 128), 1, "reflect", 4, 2, 256),
    "up1": ((BATCH, 64, 64, 256), 1, "replicate", 3, 1, 512),
    "up2": ((BATCH, 128, 128, 128), 1, "replicate", 3, 1, 256),
}
# ragged inputs of Q1 and Q2 (bf16, both modes, every output dtype): batch
# 1 with M under one 128-pixel tile, tiles straddling two images, both
# strides, C in {16, 64, 128, 256}, O in {8, 24, 128, 512}
QUANT_RAGGED = (
    ((1, 9, 11, 16), 1, "reflect", 3, 1, 8),
    ((3, 10, 7, 64), 1, "zero", 4, 2, 24),
    ((2, 13, 13, 128), 1, "replicate", 3, 1, 128),
    ((2, 20, 18, 256), 1, "reflect", 4, 2, 512),
    ((1, 33, 35, 16), 1, "reflect", 4, 2, 24),
    ((5, 16, 16, 64), 1, "reflect", 3, 1, 512),
)
QUANT_SCOPES = ("resblocks", "heavy")
# Q1 (and Q2) launches per member forward, by scope
QUANT_PER_FWD = {"resblocks": 16, "heavy": 20}
# P1 launches per member forward, by scope: a quantized conv's pad is Q2's
QUANT_PAD_PER_FWD = {"resblocks": 12, "heavy": 10}

# the card's peak rates (NVIDIA H100 SXM data sheet, dense, at the full
# 700 W): bf16 on the tensor cores, f32 on the FMA units, int8 on the
# tensor cores, device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
CONV_KERNELS = ("conv3x3", "conv3x3_dgrad", "conv3x3_wgrad")
# the same three kernels at a zero pad of 1 on the unpadded input x (B, H,
# W, C) of the "same" conv (the strips engine's interior)
PAD1_KERNELS = ("conv3x3_same_zero", "conv3x3_dgrad_pad1",
                "conv3x3_wgrad_pad1")
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
    (the dgrad's padded form would run 2*B*(H+2)*(W+2)*9*O*C); at pad 1
    (``PAD1_KERNELS``) the input x is (B, H, W, C), unpadded. Norm
    kernels: ``shape`` is (B, H, W, C)."""
    if name in CONV_KERNELS + PAD1_KERNELS:
        b, h, w, c, o = shape
        ops = 2 * b * h * w * 9 * c * o
        hx, wx = (h, w) if name in PAD1_KERNELS else (h + 2, w + 2)
        elems = b * hx * wx * c + b * h * w * o + 9 * c * o
        return ops, esize * elems, "bf16" if esize == 2 else "f32"
    if name == "conv_int8":
        # shape: a QUANT_SITES entry; int8 x (padded) and weight read, y
        # written in the compute dtype, the f32 scales and bias read
        (b, h, w, c), pad, _, k, stride, o = shape
        hp, wp = h + 2 * pad, w + 2 * pad
        ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
        ops = 2 * b * ho * wo * k * k * c * o
        nbytes = (b * hp * wp * c + k * k * c * o + esize * b * ho * wo * o
                  + 4 * (b + 2 * o))
        return ops, nbytes, "int8"
    if name in ("pad_nhwc", "pad_fold"):
        # shape: a PAD_SITES entry; x read and the padded tensor written
        # (the fold: the padded cotangent read, dx written); no arithmetic
        # but the fold's few adds at the border
        (b, h, w, c), pad = shape
        n = b * h * w * c + b * (h + 2 * pad) * (w + 2 * pad) * c
        return 0, esize * n, "f32"
    if name in ("quant_act", "quant_act_dynamic"):
        # x read once, the padded int8 codes and the scales written, in
        # both modes; a few operations per element
        (b, h, w, c), pad = shape[:2]
        n = b * h * w * c
        nbytes = esize * n + b * (h + 2 * pad) * (w + 2 * pad) * c + 4 * b
        return 4 * n, nbytes, "f32"
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
    cases += (repaired_cases(g) + eval_batch_cases(g) + engine_conv_cases(g)
              + pad_cases(g))
    return run_cases(cases, card_str)


def pad_cases(g: torch.Generator) -> list:
    """Phase 3's P1 and P1' at ``PAD_SITES`` (reflect, bf16): P1 bit-equal
    to the index gather (its plain version, and the library call beside
    it), P1' against the plain fold (one rounding of an f32 sum on either
    side); their library calls the gather and the autograd backward of the
    gather (``index_put_`` with accumulate), which the port ran before."""
    cases = []
    for shape, p in PAD_SITES:
        b, h, w, c = shape
        x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
        dy = torch.randn(b, h + 2 * p, w + 2 * p, c, device="cuda",
                         generator=g).bfloat16()
        leaf = x.clone().requires_grad_()
        out = pad_ops.pad_reference(leaf, p, "reflect")
        cases.append(("pad_nhwc", "pad", torch.bfloat16, shape, (shape, p),
                      lambda x=x, p=p: pad_ops.pad_nhwc(x, p, "reflect"),
                      lambda x=x, p=p: pad_ops.pad_reference(x, p,
                                                             "reflect"),
                      lambda x=x, p=p: pad_ops.pad_reference(x, p,
                                                             "reflect")))
        cases.append(("pad_fold", "pad_fold", torch.bfloat16, shape,
                      (shape, p),
                      lambda dy=dy, h=h, w=w, p=p: pad_ops.pad_fold(
                          dy, h, w, p, "reflect"),
                      lambda dy=dy, h=h, w=w, p=p: pad_ops.pad_fold_reference(
                          dy, h, w, p, "reflect"),
                      lambda out=out, leaf=leaf, dy=dy: torch.autograd.grad(
                          out, leaf, dy, retain_graph=True)))
    return cases


# phase 3's tolerances by (kind, dtype), relative to the largest |plain|
# value (phase_kernels' docstring)
TOL_REL = {("conv", torch.bfloat16): 2 ** -6, ("conv", torch.float32): 1e-4,
           ("wgrad", torch.bfloat16): 2 ** -7,
           ("wgrad", torch.float32): 1e-4,
           ("norm", torch.bfloat16): 2 ** -6, ("norm", torch.float32): 1e-5,
           ("norm_bwd", torch.bfloat16): 2 ** -6,
           ("norm_bwd", torch.float32): 1e-4,
           ("pad", torch.bfloat16): 0, ("pad", torch.float32): 0,
           ("pad_fold", torch.bfloat16): 2 ** -6,
           ("pad_fold", torch.float32): 1e-6}


def run_cases(cases: list, card_str: str) -> dict:
    """Phase 3's check of each case (name, kind, dtype, shape, work,
    kernel, plain, library) against its plain version at ``TOL_REL``,
    timed in turns beside its library call and its bound; the
    ``DETERMINISTIC`` ones launched twice, bit-equal. Returns the results
    by (name, dtype name, shape)."""
    results = {}
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
        rels = [TOL_REL[(kind, dt)]] + [
            TOL_REL[(kind, torch.float32 if kind == "norm" else dt)]] * (
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


def engine_conv_cases(g: torch.Generator) -> list:
    """Phase 3's cases at the conv engines' shapes: K1, K1' and K2 at both
    upsample phase convs (bf16, ``PHASE_CONV_SITES``), and at a zero pad of
    1 on the unpadded resblock input (``PAD1_SITE``, bf16 and f32): the
    forward ``conv3x3_same_zero``, its dgrad at pad 1 and K2 with the pad
    in its loads. Same tolerances as the main shapes; library calls
    F.conv2d and aten.convolution_backward at the same padding."""
    cases = []

    def conv_bwd(gn, xn, wn, pad, mask):
        return lambda: torch.ops.aten.convolution_backward(
            gn, xn, wn, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
            mask)

    def operands(b, hx, wx, c, o, dt):
        x = torch.randn(b, hx, wx, c, device="cuda", generator=g).to(dt)
        k = hwio_weight(torch.randn(o, c, 3, 3, device="cuda", generator=g)
                        / (9 * c) ** 0.5, dt)
        wn = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        return x, k, x.permute(0, 3, 1, 2), wn

    dt = torch.bfloat16
    for site, work in PHASE_CONV_SITES.items():
        b, h, w, c, o = work
        xp, k, xn, wn = operands(b, h + 2, w + 2, c, o, dt)
        gy = torch.randn(b, h, w, o, device="cuda", generator=g).to(dt)
        gn = gy.permute(0, 3, 1, 2)
        tag = f"{site} phase conv"
        cases += [
            ("conv3x3", "conv", dt, f"{tag} xp {tuple(xp.shape)} -> {o}",
             work, lambda xp=xp, k=k: conv3x3_valid(xp, k),
             lambda xp=xp, k=k: conv3x3_valid_reference(xp, k),
             lambda xn=xn, wn=wn: F.conv2d(xn, wn)),
            ("conv3x3_dgrad", "conv", dt, f"{tag} g {tuple(gy.shape)}", work,
             lambda gy=gy, k=k: conv3x3_dgrad(gy, k),
             lambda gy=gy, k=k: conv3x3_dgrad_reference(gy, k),
             conv_bwd(gn, xn, wn, 0, [True, False, False])),
            ("conv3x3_wgrad", "wgrad", dt, f"{tag} xp {tuple(xp.shape)}",
             work, lambda xp=xp, gy=gy, dt=dt: conv3x3_wgrad(xp, gy, dt),
             lambda xp=xp, gy=gy: conv3x3_wgrad_reference(xp, gy),
             conv_bwd(gn, xn, wn, 0, [False, True, False]))]
    b, h, w, c, o = PAD1_SITE
    for dt in (torch.bfloat16, torch.float32):
        x, k, xn, wn = operands(b, h, w, c, o, dt)
        gy = torch.randn(b, h, w, o, device="cuda", generator=g).to(dt)
        gn = gy.permute(0, 3, 1, 2)
        cases += [
            ("conv3x3_same_zero", "conv", dt, f"pad 1 x {tuple(x.shape)}",
             PAD1_SITE, lambda x=x, k=k: conv3x3_same_zero(x, k),
             lambda x=x, k=k: conv3x3_same_zero_reference(x, k),
             lambda xn=xn, wn=wn: F.conv2d(xn, wn, padding=1)),
            ("conv3x3_dgrad_pad1", "conv", dt, f"pad 1 g {tuple(gy.shape)}",
             PAD1_SITE, lambda gy=gy, k=k: conv3x3_dgrad(gy, k, 1),
             lambda gy=gy, k=k: conv3x3_dgrad_reference(gy, k, 1),
             conv_bwd(gn, xn, wn, 1, [True, False, False])),
            ("conv3x3_wgrad_pad1", "wgrad", dt, f"pad 1 x {tuple(x.shape)}",
             PAD1_SITE, lambda x=x, gy=gy, dt=dt: conv3x3_wgrad(x, gy, dt, 1),
             lambda x=x, gy=gy: conv3x3_wgrad_reference(x, gy, 1),
             conv_bwd(gn, xn, wn, 1, [False, True, False]))]
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


def unfold_int8(q: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """The (B Ho Wo, k k C) rows of the implicit GEMM over the padded int8
    NHWC q, in the weight's (kh, kw, C) order: a copy."""
    b, hp, wp, c = q.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    sb, sh, sw, sc = q.stride()
    rows = q.as_strided((b, ho, wo, k, k, c),
                        (sb, sh * stride, sw * stride, sh, sw, sc))
    return rows.reshape(b * ho * wo, k * k * c)


def quant_cases(g: torch.Generator, card_str: str) -> dict:
    """Phase 3's W8A8 kernels at phase 10's five conv sites (QUANT_SITES),
    bf16 input as serving runs them. Both are held bit-equal to their plain
    versions (no tolerance: integer codes and exact int32 sums, then the
    same f32 operations in the same order):

      Q2 (quant_act): the padded int8 codes (and zeros in the channels Q1's
            16-byte rows add) and the f32 scales, static (a scale that
            clips the top tenth, so the clip is exercised) and per image
            (quant_act_dynamic: one launch, its grid wait inside);
      Q1 (conv_int8): on the plain codes with per-image scales, the int32
            accumulator and the bf16 output with its bias, and at the
            resblock site the f32 output too.

    Times (:func:`time_turns`, device alone): the kernel, its plain version
    (the plain conv is a float64 cuDNN conv) and the yardsticks the port
    never calls: for Q1 ``torch._int_mm`` on the pre-unfolded (M, K) and
    (K, N) int8 matrices (the unfold is outside the timed call; its result
    is checked equal to Q1's accumulator), cuDNN's bf16 ``F.conv2d`` on the
    padded bf16 input, and K1 (conv3x3_valid) in bf16 at the 3x3 stride-1
    sites. Q2 has no library call that computes its function."""
    from councilx_torch.nn.blocks import pad2d

    results = {}
    dt = torch.bfloat16
    for site, spec in QUANT_SITES.items():
        (b, h, w, c), pad, pad_type, k, stride, o = spec
        x = (torch.randn(b, h, w, c, device="cuda", generator=g) * 2).to(dt)
        kern = torch.randn(k, k, c, o, device="cuda",
                           generator=g) / (k * k * c) ** 0.5
        bias = torch.randn(o, device="cuda", generator=g) * 0.1
        wq = quantize_weights(kern)
        a_static = (x.float().abs().amax() * 0.9 / 127).reshape(())
        for name, a_scale in (("quant_act", a_static),
                              ("quant_act_dynamic", None)):
            got_q, got_s = quantize_act(x, pad, pad_type, a_scale)
            want_q, want_s = quantize_act_reference(x, pad, pad_type, a_scale)
            torch.cuda.synchronize()
            same = (torch.equal(got_q[..., :c], want_q)
                    and not got_q[..., c:].any()
                    and torch.equal(got_s.reshape(-1), want_s.reshape(-1)))
            ms, plain_ms = time_turns(
                lambda a=a_scale: quantize_act(x, pad, pad_type, a),
                lambda a=a_scale: quantize_act_reference(x, pad, pad_type, a))
            host = host_us(lambda a=a_scale: quantize_act(x, pad, pad_type,
                                                          a))
            bms, by = bound_ms(name, (x.shape, pad))
            log(f"[kernels] {name} bf16 {site} {tuple(x.shape)} pad {pad} "
                f"{pad_type}: codes and scales bit-equal {same}; kernel "
                f"{ms:.6g} ms plain {plain_ms:.6g} ms bound {bms:.6g} ms "
                f"({by}), {100 * bms / ms:.4g}% of it; wrapper host "
                f"{host:.6g} us per call [{card_str}]")
            if not same:
                raise AssertionError(f"{name} {site}: differs from its plain "
                                     f"version")
            results[(name, site)] = {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": bms, "bound_by": by,
                "bound_share": bms / ms, "host_us": host}

        q, a_s = quantize_act_reference(x, pad, pad_type)
        for out in ((torch.int32, dt, torch.float32) if site == "resblock"
                    else (torch.int32, dt)):
            got = conv_int8(q, wq, a_s, None if out == torch.int32 else bias,
                            stride, out)
            want = conv_int8_reference(q, wq, a_s, None if out == torch.int32
                                       else bias, stride, out)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = (got.double() - want.double()).abs().max().item()
                raise AssertionError(f"conv_int8 {site} {out}: differs from "
                                     f"its plain version by {err}")
        acc = conv_int8(q, wq, a_s, None, stride, torch.int32)
        rows = unfold_int8(q, k, stride)
        w_cols = wq.w8.reshape(o, -1).t()
        mm = torch._int_mm(rows, w_cols)
        if not torch.equal(mm.view(acc.shape), acc):
            raise AssertionError(f"conv_int8 {site}: torch._int_mm's "
                                 f"accumulator differs")
        xp = pad2d(x, pad, pad_type)
        xn = xp.permute(0, 3, 1, 2)
        wn = kern.to(dt).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        yardsticks = [lambda: torch._int_mm(rows, w_cols),
                      lambda: F.conv2d(xn, wn, stride=stride)]
        if (k, stride) == (3, 1):
            hwio = hwio_weight(kern.permute(3, 2, 0, 1), dt)
            yardsticks.append(lambda: conv3x3_valid(xp, hwio))
        times = time_turns(
            lambda: conv_int8(q, wq, a_s, bias, stride, dt),
            lambda: conv_int8_reference(q, wq, a_s, bias, stride, dt),
            *yardsticks)
        ms, plain_ms, int_mm_ms, cudnn_ms = times[:4]
        k1_ms = times[4] if len(times) > 4 else None
        host, entry = conv_int8_host_us(q, wq, a_s, bias, stride, dt)
        bms, by = bound_ms("conv_int8", spec)
        log(f"[kernels] conv_int8 bf16 {site} x {tuple(q.shape)} "
            f"{k}x{k}/{stride} -> {o}: int32 accumulator and bf16 output "
            f"bit-equal{' (and f32)' if site == 'resblock' else ''}; kernel "
            f"{ms:.6g} ms plain {plain_ms:.6g} ms torch._int_mm "
            f"{int_mm_ms:.6g} ms cuDNN bf16 {cudnn_ms:.6g} ms K1 bf16 "
            f"{'n/a' if k1_ms is None else f'{k1_ms:.6g} ms'}; bound "
            f"{bms:.6g} ms ({by}), {100 * bms / ms:.4g}% of it; host per "
            f"call: wrapper {host:.6g} us, the library's entry point alone "
            f"(encodes and launch) {entry:.6g} us [{card_str}]")
        results[("conv_int8", site)] = {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": int_mm_ms, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms, "cudnn_bf16_ms": cudnn_ms,
            "k1_bf16_ms": k1_ms, "host_us": host, "entry_host_us": entry}
    quant_ragged_cases(g, card_str)
    return results


def conv_int8_host_us(q, wq, a_s, bias, stride: int, dt):
    """Host us per call of Q1: through its wrapper, and of the kernel
    library's entry point alone (the tensor-map encodes and the launch);
    the rest of a wrapper call is PyTorch's."""
    from councilx_torch.ops import quant as q_ops

    wrapper = host_us(lambda: conv_int8(q, wq, a_s, bias, stride, dt))
    b, hp, wp, cq = q.shape
    o8, kh, kw, _ = wq.w8.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    y = torch.empty(b, ho, wo, o8, dtype=dt, device=q.device)
    bk, bn = q_ops._conv_tiles(cq, o8)
    entry = q_ops._conv_int8_lib().councilx_conv_int8
    stream = torch.cuda.current_stream().cuda_stream
    lib = host_us(lambda: entry(
        q.data_ptr(), wq.w8.data_ptr(), a_s.data_ptr(), int(b > 1),
        wq.w_s.data_ptr(), None, y.data_ptr(), b, hp, wp, cq, o8, kh, kw,
        stride, ho, wo, bk, bn, 1, stream))
    return wrapper, lib


def quant_ragged_cases(g: torch.Generator, card_str: str) -> None:
    """Q2 (static and per image) and Q1 (int32, bf16 and f32 out) at the
    ragged shapes of ``QUANT_RAGGED``, bf16 input: bit-equal to their plain
    versions, and each bit-equal over two launches."""
    for shape, pad, pad_type, k, stride, o in QUANT_RAGGED:
        c = shape[-1]
        x = (torch.randn(*shape, device="cuda", generator=g) * 2).bfloat16()
        wq = quantize_weights(torch.randn(k, k, c, o, device="cuda",
                                          generator=g) / (k * k * c) ** 0.5)
        bias = torch.randn(o, device="cuda", generator=g)
        a_static = (x.float().abs().amax() * 0.8 / 127).reshape(())
        for a_scale in (None, a_static):
            mode = "static" if a_scale is not None else "per image"
            q, a_s = quantize_act(x, pad, pad_type, a_scale)
            q2, a_s2 = quantize_act(x, pad, pad_type, a_scale)
            want_q, want_s = quantize_act_reference(x, pad, pad_type,
                                                    a_scale)
            torch.cuda.synchronize()
            if not (torch.equal(q[..., :c], want_q) and not q[..., c:].any()
                    and torch.equal(a_s.reshape(-1), want_s.reshape(-1))
                    and torch.equal(q, q2) and torch.equal(a_s, a_s2)):
                raise AssertionError(f"quant_act {mode} {shape} pad {pad} "
                                     f"{pad_type}: differs from its plain "
                                     f"version or between launches")
            for out in (torch.int32, torch.bfloat16, torch.float32):
                bs = None if out == torch.int32 else bias
                got = conv_int8(q, wq, a_s, bs, stride, out)
                again = conv_int8(q, wq, a_s, bs, stride, out)
                want = conv_int8_reference(want_q, wq, want_s, bs, stride,
                                           out)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got, again)):
                    raise AssertionError(
                        f"conv_int8 {shape} {k}x{k}/{stride} -> {o} {out} "
                        f"({mode} scales): differs from its plain version "
                        f"or between launches")
        log(f"[kernels] W8A8 ragged {shape} pad {pad} {pad_type} {k}x{k}/"
            f"{stride} -> {o}: Q2 codes and scales (static, per image) and "
            f"Q1 int32/bf16/f32 bit-equal to the plain versions and across "
            f"two launches [{card_str}]")


COUNTERS = ((conv3x3_valid, ("launches", "grad_launches")),
            (conv3x3_dgrad, ("launches",)), (conv3x3_wgrad, ("launches",)),
            (instance_norm, ("launches", "affine_launches", "grad_launches",
                             "affine_grad_launches")),
            (instance_norm_backward, ("launches", "affine_launches")),
            (conv_int8, ("launches",)),
            (quantize_act, ("launches", "per_image_launches")),
            (pad_nhwc, ("launches",)), (pad_fold, ("launches",)))


def reset_counts():
    for fn, names in COUNTERS:
        for name in names:
            setattr(fn, name, 0)


def counts():
    return (conv3x3_valid.launches, instance_norm.launches,
            instance_norm.affine_launches, pad_nhwc.launches,
            pad_fold.launches)


def check_counts(got, forwards: int, where: str):
    want = (CONV_PER_FWD * forwards, NORM_PER_FWD * forwards,
            ADAIN_PER_FWD * forwards, PAD_PER_FWD * forwards, 0)
    log(f"[serve] {where}: launches conv/norm/adain/P1/P1' {got}, want "
        f"{want} for {forwards} member forwards")
    if got != want:
        raise AssertionError(f"{where}: kernel launches {got} != {want}")


def engine_forwards(engine, batches: int) -> int:
    """Member forwards through the kernel wrappers of an engine built with
    warm-up and then ``batches`` batches, each of its members': on the
    captured route one eager run and one capture per bucket at warm-up,
    after which a batch replays and calls no wrapper; eagerly one run per
    bucket at warm-up and one per batch."""
    per = 2 * len(engine.buckets) if engine.graphs else \
        len(engine.buckets) + batches
    return per * engine.n_members


def check_replays(engine, batches: int, where: str) -> None:
    """On the captured route every batch, and each bucket's warm-up, is a
    replay."""
    want = len(engine.buckets) + batches if engine.graphs else 0
    if engine.replays != want:
        raise AssertionError(f"{where}: {engine.replays} replays, want "
                             f"{want}")


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

    # counted from before the engine's warm-up: on the default captured
    # route the buckets' captures hold the launches, the requests replay
    reset_counts()
    engine = build_engine(cfg, ckpt, "0", "a2b", max_batch=BATCH,
                          max_delay_ms=200.0, warmup=True, device="cuda")
    try:
        if not engine.graphs:
            raise AssertionError("build_engine on the card did not take "
                                 "the captured route")
        outs = submit_all(engine, images, seeds)
        torch.cuda.synchronize()
        launches = counts()
        stats = engine.snapshot_stats()
        check_counts(launches, engine_forwards(engine, stats["batches"]),
                     "member 0")
        check_replays(engine, stats["batches"], "member 0")
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
        throughput = {"engine_ips": engine_ips, "device_ips": device_ips}
        log(f"[serve] /stats {json.dumps(engine.snapshot_stats())} "
            f"[{card_str}]")
    finally:
        engine.stop()

    reset_counts()
    engine = build_engine(cfg, ckpt, "all", "a2b", max_batch=BATCH,
                          max_delay_ms=200.0, warmup=True, device="cuda")
    try:
        outs = submit_all(engine, images[:4], seeds[:4])
        torch.cuda.synchronize()
        ens_launches = counts()
        stats = engine.snapshot_stats()
        check_counts(ens_launches, engine_forwards(engine, stats["batches"]),
                     "all")
        check_replays(engine, stats["batches"], "all")
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
    return ckpt, throughput


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


def check_quant_counts(got: dict, forwards: int, scope: str, mode: str,
                       where: str) -> None:
    """Phase 10's launches over ``forwards`` member forwards: Q1 and Q2
    once each at every quantized conv of ``scope`` (Q2 one launch in either
    mode, all of them per image under ``w8a8``), K1 at none (every 3x3
    stride-1 site is quantized), the norms as unquantized, nothing under a
    gradient; P1 at the unquantized convs' pads."""
    per = QUANT_PER_FWD[scope] * forwards
    want = {name: 0 for name in got}
    want.update({"conv_int8.launches": per, "quantize_act.launches": per,
                 "quantize_act.per_image_launches": per if mode == "w8a8"
                 else 0,
                 "instance_norm.launches": NORM_PER_FWD * forwards,
                 "instance_norm.affine_launches": ADAIN_PER_FWD * forwards,
                 "pad_nhwc.launches": QUANT_PAD_PER_FWD[scope] * forwards})
    log(f"[quant] {where}: launches {json.dumps(got)} for {forwards} member "
        f"forwards")
    if got != want:
        raise AssertionError(f"{where}: launches {got} != {want}")


def _translate_with_codes(tr: Translator, gen, x, z, scope: str, stats):
    """(output, codes): one translate call, and the codes of the first
    quantized conv's input in it (per image, or with the calibrated static
    scale), made on the CPU by the plain quantize."""
    from councilx_torch.ckpt.torch_convert import quant_stat_names
    from councilx_torch.ops.quant import div127

    name = ("enc_content.model.1" if scope == "heavy"
            else "enc_content.model.3.model.0.model.0")
    seen = {}

    def grab(module, args):     # returns None: the input goes on unchanged
        seen["x"] = args[0].float().cpu()

    hook = dict(gen.named_modules())[name].register_forward_pre_hook(grab)
    try:
        out = tr.translate(gen, x, z)[0].cpu().numpy()
    finally:
        hook.remove()
    a_scale = None
    if stats is not None:
        node = stats
        names = quant_stat_names(FLAGSHIP["gen"]["n_downsample"],
                                 FLAGSHIP["gen"]["n_res"])
        for key in dict((n, p) for p, n in names)[name]:
            node = node[key]
        a_scale = div127(torch.tensor(float(node)))
    return out, quantize_act_reference(seen["x"], 0, "zero", a_scale)[0]


def _to(obj, device):
    """Tensors in nested tuples/lists moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, device) for o in obj)
    return obj


def quant_accuracy(ckpt: str, scope: str, mode: str, stats, card_str: str):
    """Phase 10's accuracy: member 0, 2 random images, fixed z, quantized
    as ``mode`` in ``scope`` (``stats``: the calibration tree of the static
    mode), the card against the port on the CPU in f32 with the same
    quantization on the plain versions.

    Quantization makes the output jump where a code flips, and at full
    width flips cascade: one flip (an f32 summation-order difference of
    ~1e-7 upstream that lands on a rounding boundary) moves the next
    conv's inputs by ~1e-3 of their range, which flips many of their codes,
    and so on through 16-20 quantized convs. The CPU path itself moves by
    about the size of the quantization error when its input moves by one
    ulp; the phase measures that ("noise floor") on the same images. So the
    card is held:
      per block, in f32: every quantized block run on the card on the
            input the CPU block got (its AdaIN pair too) matches the CPU
            block's output within 1e-5 of its largest value -- the same
            codes, exact sums, then the norm's f32 sums in another order;
      in f32: the first quantized conv's input codes in the card's own
            pass equal the CPU's but for at most 1e-3 of them (summation
            order only, nothing quantized upstream);
      at the output: f32 within mean 1e-3 + 2 x the floor's mean, max
            5e-2 + 2 x the floor's max; bf16 within phase 5's mean 2e-2
            and max 0.25 plus the same 2 x floor (bf16 rounding is a
            larger perturbation than one ulp; its cascade ends at the same
            scale)."""
    from councilx_torch.ckpt.manager import load_generator_state_dicts

    quant = {"quant": mode, "quant_scope": scope}
    cfg32 = Config.from_dict({**FLAGSHIP, **quant,
                              "compute_dtype": "float32"})
    sd0 = load_generator_state_dicts(ckpt, cfg32)[0]
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    tr_cpu = Translator(cfg32, quant_stats=stats, device="cpu")
    gen_cpu = tr_cpu.load_members([sd0])[0]
    seen = {}

    def keep(name):
        def hook(module, args, out):    # returns None: output unchanged
            seen.setdefault(name, (args, out))
        return hook

    hooks = [m.register_forward_hook(keep(n))
             for n, m in gen_cpu.quant_blocks().items()]
    try:
        ref, ref_codes = _translate_with_codes(tr_cpu, gen_cpu, x, z, scope,
                                               stats)
    finally:
        for h in hooks:
            h.remove()
    if not np.isfinite(ref).all():
        raise AssertionError("CPU reference: non-finite values")
    floor = np.abs(tr_cpu.translate(gen_cpu, x * np.float32(1 + 2 ** -23),
                                    z)[0].numpy() - ref)
    log(f"[quant] {mode} {scope}: noise floor, the CPU's f32 output with "
        f"its input moved by one ulp: mean abs {floor.mean():.6g} max abs "
        f"{floor.max():.6g}")
    for name, cfg, base_mean, base_max in (
            ("f32", cfg32, 1e-3, 5e-2),
            ("bf16", Config.from_dict({**FLAGSHIP, **quant}), 2e-2, 0.25)):
        tol_mean = base_mean + 2 * float(floor.mean())
        tol_max = base_max + 2 * float(floor.max())
        tr = Translator(cfg, quant_stats=stats, device="cuda")
        gen = tr.load_members([sd0])[0]
        got, codes = _translate_with_codes(tr, gen, x, z, scope, stats)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{name}: {got.shape}, non-finite values")
        d = np.abs(got - ref)
        extra = ""
        if name == "f32":
            n_flip = int((codes != ref_codes).sum())
            blocks = gen.quant_blocks()
            worst = 0.0
            with torch.inference_mode():
                for bname, (args, out) in seen.items():
                    y = blocks[bname](*_to(args, "cuda")).float().cpu()
                    worst = max(worst, float((y - out).abs().max())
                                / float(out.abs().max()))
            extra = (f"; first quantized conv: {n_flip} of {codes.numel()} "
                     f"codes differ (tol {1e-3 * codes.numel():.6g}); each "
                     f"of the {len(seen)} quantized blocks on the CPU "
                     f"block's input: worst {worst:.6g} of its largest "
                     f"value (tol 1e-5)")
            if n_flip > 1e-3 * codes.numel() or worst > 1e-5:
                raise AssertionError(f"{mode} {scope}: the card's quantized "
                                     f"blocks disagree with the CPU's{extra}")
        log(f"[quant] {mode} {scope}: card {name} vs CPU f32, member 0 at "
            f"batch 2: mean abs {d.mean():.6g} max abs {d.max():.6g} (tol "
            f"mean {tol_mean:.6g}, max {tol_max:.6g}){extra} [{card_str}]")
        if not (d.mean() <= tol_mean and d.max() <= tol_max):
            raise AssertionError(f"card {name} {mode} {scope} disagrees with "
                                 f"the CPU")


def phase_quant(card_str: str, tmp: str, ckpt: str, none_tp: dict) -> dict:
    """Phase 10: W8A8 serving through the user's entry points, at full
    width, in both scopes and both serving modes. Returns the launch
    counts summed over the engines' runs (each counted from before its
    engine's warm-up, which on the captured route holds the launches)."""
    import yaml

    from councilx_torch.ckpt.manager import load_params_npz
    from councilx_torch.config import load_config
    from councilx_torch.tools import calibrate_quant, quant_quality

    test_a = os.path.join(tmp, "data", "testA")    # phase 9's folders
    rng = np.random.default_rng(10)
    n_req = 2 * BATCH
    images = rng.integers(0, 256, (n_req, HW, HW, 3), dtype=np.uint8)
    seeds = [2000 + i for i in range(n_req)]
    total = {}
    for scope in QUANT_SCOPES:
        cfg_path = os.path.join(tmp, f"quant_{scope}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({**FLAGSHIP, "quant_scope": scope}, f)
        calib = os.path.join(tmp, f"quant_stats_{scope}.npz")
        t0 = time.perf_counter()
        summary = calibrate_quant.main([
            "--config", cfg_path, "--checkpoint", ckpt, "--member", "0",
            "--input_folder", test_a, "--batch_size", str(BATCH),
            "--num_batches", str(CLI_IMAGES // BATCH), "--num_style", "4",
            "--out", calib])
        log(f"[quant] {scope}: calibrate_quant over testA {summary} in "
            f"{time.perf_counter() - t0:.6g} s [{card_str}]")
        if summary["convs"] != QUANT_PER_FWD[scope]:
            raise AssertionError(f"calibrated {summary['convs']} convs")
        stats = load_params_npz(calib)
        for mode in ("w8a8", "w8a8_static"):
            cfg = load_config(cfg_path)
            cfg.quant = mode
            reset_counts()
            engine = build_engine(
                cfg, ckpt, "0", "a2b", max_batch=BATCH, max_delay_ms=200.0,
                calibration=calib if mode == "w8a8_static" else None,
                warmup=True, device="cuda")
            where = f"{mode} {scope}"
            try:
                outs = submit_all(engine, images, seeds)
                torch.cuda.synchronize()
                got = _snapshot()
                st = engine.snapshot_stats()
                if st["batch_size_histogram"] != {BATCH: n_req // BATCH}:
                    raise AssertionError(f"{where}: not full buckets {st}")
                check_quant_counts(got, engine_forwards(engine,
                                                        st["batches"]),
                                   scope, mode, where)
                check_replays(engine, st["batches"], where)
                for key, n in got.items():
                    total[key] = total.get(key, 0) + n
                zs = np.stack([engine.make_z(sd) for sd in seeds])
                direct = np.concatenate([engine.translator.translate_u8io(
                    engine.params, images[j:j + BATCH], z=zs[j:j + BATCH])
                    for j in range(0, n_req, BATCH)])
                worst = max(int(np.abs(o.astype(np.int16) - direct[i].astype(
                    np.int16)).max()) for i, o in enumerate(outs))
                if worst > 1 or any(o.shape != (HW, HW, 3) for o in outs):
                    raise AssertionError(f"{where}: engine vs direct differs "
                                         f"by {worst} levels")
                n_tp = 32 * BATCH
                for f in [engine.submit(im, seed=0)
                          for im in images[:BATCH]]:
                    f.result(timeout=300)
                t0 = time.perf_counter()
                for f in [engine.submit(im, seed=i) for i, im in
                          enumerate(np.repeat(images[:BATCH], 32, axis=0))]:
                    f.result(timeout=300)
                engine_ips = n_tp / (time.perf_counter() - t0)
                x8 = torch.from_numpy(images[:BATCH]).cuda()
                z8 = torch.randn(BATCH, cfg.gen.style_dim).cuda()
                ms = float(np.median(median_ms(
                    lambda: engine.translator.translate_u8io_device(
                        engine.params, x8, z=z8), reps=10)))
                log(f"[quant] {where}: {n_req} requests, each within "
                    f"{worst} uint8 level(s) of a direct call at bucket "
                    f"{BATCH}; engine {engine_ips:.6g} img/s, device call "
                    f"{ms:.6g} ms = {BATCH / (ms / 1e3):.6g} img/s, beside "
                    f"quant none's {none_tp['engine_ips']:.6g} / "
                    f"{none_tp['device_ips']:.6g} img/s (phase 4) "
                    f"[{card_str}]")
            finally:
                engine.stop()
            quant_accuracy(ckpt, scope, mode,
                           stats if mode == "w8a8_static" else None, card_str)
        t0 = time.perf_counter()
        gate = quant_quality.compare(cfg_path, ckpt, 0, "a2b",
                                     ["w8a8", "w8a8_static"],
                                     calibration=calib, input_folder=test_a,
                                     batch_size=BATCH,
                                     num_batches=CLI_IMAGES // BATCH)
        for mode, m in gate.items():
            log(f"[quant] quality gate {scope} {json.dumps(m)} (the JAX "
                f"package's bar: meanabs_u8 < 8, maxabs_u8 < 128, "
                f"psnr_min_db > 20) [{card_str}]")
            if not (m["images"] == CLI_IMAGES and m["meanabs_u8"] < 8.0
                    and m["maxabs_u8"] < 128 and m["psnr_min_db"] > 20.0):
                raise AssertionError(f"quality gate {scope} {mode}: {m}")
        log(f"[quant] quality gate {scope}: {time.perf_counter() - t0:.6g} s")
    return total


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
    log(f"[train] launches over the timed steps {json.dumps(got)}")
    check_train_launches(got, TIMED_STEPS, "train")
    return got, BATCH * TIMED_STEPS / seconds


def check_train_launches(got: dict, steps: int, where: str,
                         conv_per_member: int = TRAIN_CONV_PER_MEMBER,
                         pads: tuple = (TRAIN_PAD_PER_MEMBER,
                                        TRAIN_FOLD_PER_MEMBER)) -> None:
    """The launch invariants of ``steps`` headline train steps: every
    kernel site ran under autograd, and every forward under autograd had
    its backward (conv fwd = dgrad = wgrad, norm fwd = bwd).
    ``conv_per_member``: K1's sites per member and step (more under the
    phase upsample engines: :func:`engine_conv_per_fwd`); ``pads``: P1's
    and P1''s per member and step (``ENGINE_TRAIN_PADS``)."""
    forwards = steps * N_MEMBERS
    conv = conv_per_member * forwards
    norm = TRAIN_NORM_PER_MEMBER * forwards
    adain = TRAIN_ADAIN_PER_MEMBER * forwards
    want = {name: 0 for name in got}
    want.update({
        "conv3x3_valid.launches": conv, "conv3x3_valid.grad_launches": conv,
        "conv3x3_dgrad.launches": conv, "conv3x3_wgrad.launches": conv,
        "instance_norm.launches": norm, "instance_norm.grad_launches": norm,
        "instance_norm.affine_launches": adain,
        "instance_norm.affine_grad_launches": adain,
        "instance_norm_backward.launches": norm,
        "instance_norm_backward.affine_launches": adain,
        "pad_nhwc.launches": pads[0] * forwards,
        "pad_fold.launches": pads[1] * forwards})
    if got != want:
        raise AssertionError(f"{where} launches {got} != {want}")


# the forward launch counters, each made again by a stage's recompute
FORWARD_COUNTERS = ("conv3x3_valid.launches", "conv3x3_valid.grad_launches",
                    "instance_norm.launches", "instance_norm.affine_launches",
                    "instance_norm.grad_launches",
                    "instance_norm.affine_grad_launches")


def remat_stage_launches(plain: dict, steps: int) -> dict:
    """The launch counts of ``steps`` train steps under ``remat_stages``
    from those of the same steps without it. Every conv and norm kernel
    site of a step lies in a checkpointed stage (the content encoder's 7x7
    block, downsamples and resblocks; the decoder's resblocks; the style
    encoder, which is not checkpointed, has none), and each stage's
    recompute runs its forward once more under autograd: every forward
    count doubles, the backward counts stay. P1 runs again at the
    ``REMAT_PAD_PER_MEMBER`` pads inside the stages of each of ``steps``
    headline steps (the style encoders' and the discriminators' lie
    outside them), where ``plain`` counts P1; P1' runs as often."""
    out = {k: 2 * v if k in FORWARD_COUNTERS else v
           for k, v in plain.items()}
    if "pad_nhwc.launches" in out:
        out["pad_nhwc.launches"] += REMAT_PAD_PER_MEMBER * steps * N_MEMBERS
    return out


def phase_train_accuracy(card_str: str, over=None,
                         tag: str = "[train-accuracy]", parity: bool = True,
                         modes=("f32", "bf16")):
    """Phase 7: the first two steps of a reduced config (council-2, 64px,
    gen dim 32, n_res 2, dis dim 16 with 2 layers and 2 scales, batch 2) on
    the card against the port on the CPU in f32 (the plain versions), from
    the same weights, batch and z. ``over``: settings added to the config
    on both sides (phase 12's options, the engines phase's), ``tag`` the
    lines' prefix; ``parity`` False runs f32 outside parity mode (the
    config's engines), ``modes`` the card's dtypes.

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
    reduced = {**REDUCED, **(over or {})}
    cfg32 = Config.from_dict({**reduced, "parity_mode": parity})
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
            ("bf16", Config.from_dict({**reduced,
                                       "compute_dtype": "bfloat16"}),
             (3e-2, 3e-2), 1e-3)):
        if name not in modes:
            continue
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
            log(f"{tag} card {name} step {step + 1} vs CPU f32: "
                f"worst metric {worst} rel {rel[worst]:.6g} (rtol "
                f"{rtols[step]}, atol {atol}) [{card_str}]")
            for k in want:
                if abs(got[k] - want[k]) > atol + rtols[step] * abs(want[k]):
                    raise AssertionError(
                        f"card {name} step {step + 1}: {k} {got[k]} vs CPU "
                        f"{want[k]}")


# the engines phase: the JAX generator's conv-engine settings over the
# flagship serving model and the headline train step (config keys; the
# first is the reference route, which parity_mode also takes)
ENGINE_SERVE = (
    ("reference", {"fuse_upsample": False, "boundary_engine": "reference"}),
    ("defaults", {}),
    ("phase", {"upsample_engine": "phase"}),
    ("ln_fused", {"upsample_engine": "ln_fused"}),
    ("resblock_fuse_pad", {"resblock_fuse_pad": True}),
)
ENGINE_TRAIN = (
    ("reference", {"fuse_upsample": False, "boundary_engine": "reference"}),
    ("defaults", {}),
    ("phase+resblock_fuse_pad", {"upsample_engine": "phase",
                                 "resblock_fuse_pad": True}),
)
# P1 launches per member forward under each of ENGINE_SERVE (the reference
# route pads the 7x7s unpacked and the upsample convs whole; phase and
# ln_fused pad the pre-upsample input of each upsample block's phase conv
# besides; resblock_fuse_pad's strips pad each resblock conv's border
# slices), and P1 and P1' per member and train step under ENGINE_TRAIN
ENGINE_SERVE_PADS = {"reference": 22, "defaults": PAD_PER_FWD, "phase": 30,
                     "ln_fused": 30, "resblock_fuse_pad": 76}
ENGINE_TRAIN_PADS = {"reference": (110, 99),
                     "defaults": (TRAIN_PAD_PER_MEMBER,
                                  TRAIN_FOLD_PER_MEMBER),
                     "phase+resblock_fuse_pad": (222, 211)}
# wall-timed serving calls per setting, and calls (steps) under the profiler
ENGINE_CALLS, ENGINE_PROFILED = 10, 3


def engine_conv_per_fwd(over: dict) -> int:
    """K1 launches per member forward under the engine settings ``over``:
    the 16 resblock convs (at pad 1 under resblock_fuse_pad), and the two
    upsample blocks' phase conv under upsample_engine phase or ln_fused."""
    phase = (over.get("fuse_upsample", True)
             and over.get("upsample_engine", "dilated") != "dilated")
    return CONV_PER_FWD + (2 if phase else 0)


def engine_train_conv(over: dict) -> int:
    """K1 sites per member and headline train step under ``over``: the two
    decodes (the translation's and recon_x's) each add their upsample
    blocks' phase convs."""
    return TRAIN_CONV_PER_MEMBER + 2 * (engine_conv_per_fwd(over)
                                        - CONV_PER_FWD)


def kernel_profile(fn, calls: int):
    """(kernel ms, kernel launches) per call of fn, from the CUDA events of
    a torch.profiler trace of ``calls`` calls (the trace is taken again, up
    to twice, if it holds no device event)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        n = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total += e.time_range.elapsed_us()
                n += 1
        if n:
            return total / 1e3 / calls, n / calls
    raise AssertionError("the profiler recorded no device event")


def _engine_close(got, want, what: str, card_str: str) -> None:
    """Phase 5's bf16 tolerances in [-1, 1] output units: mean 2e-2, max
    0.25."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"[engines] {what}: {got.shape}, non-finite")
    d = np.abs(got - want)
    log(f"[engines] {what}: mean abs {d.mean():.6g} max abs {d.max():.6g} "
        f"(tol mean 0.02, max 0.25) [{card_str}]")
    if not (d.mean() <= 2e-2 and d.max() <= 0.25):
        raise AssertionError(f"[engines] {what} disagrees")


def engines_serve(card_str: str) -> dict:
    """The flagship model's member 0 at bucket 8 under each of
    ``ENGINE_SERVE``: its bf16 output against the card's reference route
    at the same bucket and, on 2 images, against the CPU f32 Translator of
    the same setting; K1, norm and P1 launches per forward; wall ms per
    ``translate_u8io_device`` call (host clock around synchronized calls,
    median of ENGINE_CALLS), kernel ms per call under the profiler."""
    sd = Translator(Config.from_dict(FLAGSHIP), device="cpu").init_members(
        1, seed=0)[0].state_dict()
    rng = np.random.default_rng(3)
    x8 = rng.uniform(-1, 1, (BATCH, HW, HW, 3)).astype(np.float32)
    z8 = rng.standard_normal((BATCH, 8)).astype(np.float32)
    xu8 = torch.from_numpy(rng.integers(0, 256, (BATCH, HW, HW, 3),
                                        dtype=np.uint8)).cuda()
    zt = torch.from_numpy(z8).cuda()
    out, ref8 = {}, None
    for name, over in ENGINE_SERVE:
        raw = {**FLAGSHIP, **over}
        tr = Translator(Config.from_dict(raw), device="cuda")
        gen = tr.load_members([sd])[0]
        tr.translate(gen, x8, z8)
        torch.cuda.synchronize()
        reset_counts()
        got8 = tr.translate(gen, x8, z8)[0]
        torch.cuda.synchronize()
        launches = _snapshot()
        got8 = got8.float().cpu().numpy()
        want = (engine_conv_per_fwd(over), NORM_PER_FWD, ADAIN_PER_FWD,
                ENGINE_SERVE_PADS[name], 0)
        if counts() != want:
            raise AssertionError(f"[engines] {name}: launches conv/norm/"
                                 f"adain/P1/P1' {counts()} != {want} per "
                                 f"forward")
        if ref8 is None:
            ref8 = got8
        else:
            _engine_close(got8, ref8, f"serve {name} vs the card's reference "
                          f"route, bf16 at bucket {BATCH}", card_str)
        cpu = Translator(Config.from_dict({**raw, "compute_dtype":
                                           "float32"}), device="cpu")
        want2 = cpu.translate(cpu.load_members([sd])[0], x8[:2],
                              z8[:2])[0].numpy()
        got2 = tr.translate(gen, x8[:2], z8[:2])[0].float().cpu().numpy()
        _engine_close(got2, want2, f"serve {name}: card bf16 vs CPU f32 at "
                      f"batch 2", card_str)

        def call():
            return tr.translate_u8io_device(gen, xu8, z=zt)

        for _ in range(3):
            call()
        walls = []
        for _ in range(ENGINE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        kernel_ms, n = kernel_profile(call, ENGINE_PROFILED)
        out[name] = {"wall_ms": float(np.median(walls)),
                     "kernel_ms": kernel_ms, "kernel_launches": n,
                     "launches": launches}
        log(f"[engines] serve {name} {json.dumps(over)}: bucket {BATCH} wall "
            f"{out[name]['wall_ms']:.6g} ms/call, kernels {kernel_ms:.6g} "
            f"ms ({n:.6g} kernel launches); per forward K1 "
            f"{launches['conv3x3_valid.launches']}, norm "
            f"{launches['instance_norm.launches']} (AdaIN "
            f"{launches['instance_norm.affine_launches']}), P1 "
            f"{launches['pad_nhwc.launches']} [{card_str}]")
        del tr, gen
    return out


def engines_train(card_str: str) -> dict:
    """The headline train step under each of ``ENGINE_TRAIN``: 2 warm and
    10 timed steps (ms per step, host clock), every metric finite, the
    launch invariants (K1's sites per :func:`engine_train_conv`, P1's and
    P1''s per ``ENGINE_TRAIN_PADS``), peak memory, and kernel ms of one
    step under the profiler."""
    rng = np.random.default_rng(0)
    x_a, x_b = (torch.from_numpy(rng.uniform(-1, 1, (BATCH, HW, HW, 3))
                                 .astype(np.float32)).cuda()
                for _ in range(2))
    out = {}
    for name, over in ENGINE_TRAIN:
        trainer = CouncilTrainer(Config.from_dict({**HEADLINE, **over}),
                                 device="cuda")
        holder = {"state": trainer.init_state(seed=0)}

        def step():
            holder["state"], m = trainer.train_step(holder["state"], x_a,
                                                    x_b)
            return m

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARM_STEPS):
            step()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        series = [step() for _ in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
        launches = _snapshot()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(_finite(m) for m in series):
            raise AssertionError(f"[engines] train {name}: non-finite "
                                 f"metrics")
        check_train_launches(launches, TIMED_STEPS, f"[engines] {name}",
                             engine_train_conv(over),
                             ENGINE_TRAIN_PADS[name])
        kernel_ms, n = kernel_profile(step, 1)
        out[name] = {"ms_per_step": ms, "kernel_ms": kernel_ms,
                     "kernel_launches": n, "peak_gib": peak,
                     "launches": launches}
        log(f"[engines] train {name} {json.dumps(over)}: {ms:.6g} ms/step "
            f"over {TIMED_STEPS} steps after {WARM_STEPS}; kernels "
            f"{kernel_ms:.6g} ms ({n:.6g} kernel launches) per step; peak "
            f"{peak:.6g} GiB; "
            f"launches over the timed steps {json.dumps(launches)} "
            f"[{card_str}]")
        del trainer, holder
        torch.cuda.empty_cache()
    return out


def phase_engines(card_str: str) -> dict:
    """The engines phase (``[engines]``): the JAX generator's conv engines
    at full width, served (:func:`engines_serve`) and trained
    (:func:`engines_train`), then phase 7's reduced config in f32 outside
    parity mode under the last training setting's engines (phase
    upsample, phase_fused 7x7, the resblocks' strips on K1 at pad 1) on
    the card against the CPU, at phase 7's f32 tolerances (TF32 off, as
    :func:`main` sets it, also when the phase runs alone)."""
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"serve": engines_serve(card_str),
           "train": engines_train(card_str)}
    phase_train_accuracy(card_str, dict(ENGINE_TRAIN[-1][1]), "[engines]",
                         parity=False, modes=("f32",))
    log(f"[engines] phase {time.perf_counter() - t0:.6g} s [{card_str}]")
    return out


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
    # cuDNN deterministic for the loop's runs: the resumed run is held bit
    # for bit against an uninterrupted one (below)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
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
    # sheets' member forwards (no grad). On the captured route a run's
    # first step is eager and its second is captured (and replayed); the
    # later ones replay and call no wrapper
    if not (first["graphs"] and resumed["graphs"]):
        raise AssertionError("the train CLI on the card did not take the "
                             "captured route")
    log(f"[train-cli] captured step: capture s {first['capture_seconds']} "
        f"and {resumed['capture_seconds']} (resumed) [{card_str}]")
    steps = sum(min(n, 2) for n in (CLI_STEPS, CLI_RESUME_STEPS)) * \
        N_MEMBERS
    conv = TRAIN_CONV_PER_MEMBER * steps
    norm = TRAIN_NORM_PER_MEMBER * steps
    adain = TRAIN_ADAIN_PER_MEMBER * steps
    # per image_save_iter a test and a train sheet, per image_display_iter
    # the "current" one: each sheet one forward of every member
    sheets = sum(2 * (s % CLI_CADENCE["image_save_iter"] == 0)
                 + (s % CLI_CADENCE["image_display_iter"] == 0)
                 for s in range(1, end + 1))
    fwd = sheets * N_MEMBERS
    want = {name: 0 for name in got}
    want.update({
        "conv3x3_valid.launches": conv + CONV_PER_FWD * fwd,
        "conv3x3_valid.grad_launches": conv,
        "conv3x3_dgrad.launches": conv, "conv3x3_wgrad.launches": conv,
        "instance_norm.launches": norm + NORM_PER_FWD * fwd,
        "instance_norm.grad_launches": norm,
        "instance_norm.affine_launches": adain + ADAIN_PER_FWD * fwd,
        "instance_norm.affine_grad_launches": adain,
        "instance_norm_backward.launches": norm,
        "instance_norm_backward.affine_launches": adain,
        "pad_nhwc.launches": TRAIN_PAD_PER_MEMBER * steps + PAD_PER_FWD * fwd,
        "pad_fold.launches": TRAIN_FOLD_PER_MEMBER * steps})
    log(f"[train-cli] launches over the loop's {end} steps and "
        f"{fwd} sample-sheet member forwards {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"train-cli launches {got} != {want}")

    # bitwise resume on the captured loop: the same 8 steps in one run
    whole = os.path.join(tmp, "runs_whole")
    t0 = time.perf_counter()
    try:
        train_cli.main(["--config", cfg_path, "--output_path", whole,
                        "--max_steps", str(end)])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    from councilx_torch.ckpt.manager import restore_checkpoint

    pairs = [restore_checkpoint(os.path.join(o, "headline", "checkpoints"))
             for o in (out, whole)]
    diff = payload_diff(pairs[0][0], pairs[1][0])
    logs = [{k: {m: v for m, v in r.items()
                 if m not in ("time", "images_per_sec")}
             for k, r in _metric_steps(os.path.join(
                 o, "headline", "metrics.jsonl")).items()}
            for o in (out, whole)]
    if diff or not pairs[0][1] == pairs[1][1] == end or logs[0] != logs[1]:
        raise AssertionError(f"train-cli: {CLI_STEPS} + {CLI_RESUME_STEPS} "
                             f"resumed steps differ from {end} in one run: "
                             f"state at {diff[:6]}, logs equal "
                             f"{logs[0] == logs[1]}")
    del pairs
    log(f"[train-cli] bitwise resume on the captured loop: {CLI_STEPS} + "
        f"{CLI_RESUME_STEPS} resumed steps equal {end} steps in one run "
        f"(every parameter, Adam moment and count, the step, the z "
        f"generator, every logged metric; cuDNN deterministic), the "
        f"uninterrupted run {time.perf_counter() - t0:.6g} s with the "
        f"comparison [{card_str}]")

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
                 "instance_norm.affine_launches": ADAIN_PER_FWD * fwd,
                 "pad_nhwc.launches": PAD_PER_FWD * fwd})
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


def headline_batch(device) -> tuple:
    """Phase 11's global headline batch (seeded), on ``device``."""
    rng = np.random.default_rng(11)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, (BATCH, HW, HW, 3))
                                  .astype(np.float32)).to(device)
                 for _ in range(2))


def host_steps(trainer, state, x_a, x_b, steps: int):
    """``steps`` train steps -> (state, host metrics per step, ms per step
    by the host clock around each synchronized step)."""
    metrics, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, x_a, x_b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, ms


def payload_diff(a, b, where="") -> list:
    """Where two snapshot payloads differ (bitwise)."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            return [where]
        return [w for k in a for w in payload_diff(a[k], b[k],
                                                   f"{where}/{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            return [where]
        return [w for i, (u, v) in enumerate(zip(a, b))
                for w in payload_diff(u, v, f"{where}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [where]
    return [] if a == b else [where]


def max_param_diff(got: dict, want: dict, off: int) -> float:
    """Largest |got - want| over the parameters of the members that
    ``got`` ({direction: {group: [state dicts]}}, the members from ``off``)
    holds, against ``want`` (all members)."""
    worst = 0.0
    for d, groups in got.items():
        for grp, sds in groups.items():
            for i, sd in enumerate(sds):
                ref = want[d][grp][off + i]
                worst = max([worst] + [float((v.float() - ref[k].float())
                                             .abs().max())
                                       for k, v in sd.items()])
    return worst


def _route_run(trainer, x_a, x_b, compiled: bool, z_sample,
                first_path=None) -> dict:
    """MULTI_STEPS + MULTI_TIMED headline steps of ``trainer`` from
    ``init_state(0)``: eagerly, or one eager step and then the compiled
    step (its eager warm-up call, the capture, replays); after step
    MULTI_STEPS + 2 an eager sample (z given) and snapshot, the loop's
    collectives between two replays. -> metrics and host ms per step, the
    launches of the eager calls and the capture, the final snapshot, the
    sample, peak memory, the state and the compiled step. With
    ``first_path``: the parameters after step 1 saved there."""
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_fn = trainer.train_step
    out = {"metrics": [], "ms": [], "step": None}
    for i in range(MULTI_STEPS + MULTI_TIMED):
        if compiled and i == 1:
            step_fn = out["step"] = trainer.compile_step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, x_a, x_b)
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if first_path and i == 0:
            torch.save({"params": state.state_dicts()}, first_path)
        if i == MULTI_STEPS:
            # the eager calls and the capture; a replay calls no wrapper,
            # and the sample below launches forwards of its own
            out["launches"] = _snapshot()
        if i == MULTI_STEPS + 1:
            out["sample"] = trainer.sample(state, x_a, z=z_sample)[0].cpu()
            out["mid_snapshot"] = trainer.snapshot(state)
    out["payload"] = trainer.snapshot(state)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["state"] = state
    return out


def state_bytes(state) -> int:
    """The bytes of a TrainState's parameters and Adam moments."""
    return sum(t.numel() * t.element_size() for grp in GROUPS
               for t in group_params(getattr(state, grp))
               + getattr(state, f"opt_{grp}").mu
               + getattr(state, f"opt_{grp}").nu)


def multi_train_world1(card_str: str, ref_path: str) -> list:
    """Phase 11's training: CouncilTrainer's MULTI_STEPS + MULTI_TIMED
    eager steps; then DataParallelTrainer and CouncilShardTrainer (D = 1,
    K = 1) in the NCCL group of one rank, each as many eager steps and,
    from the same weights, batch and z, MULTI_STEPS eager calls and the
    compiled step's replays (:func:`_route_run`): every metric,
    parameter, buffer and Adam moment, the sample and the snapshot taken
    between replays bit-equal to the same trainer's eager steps and to
    CouncilTrainer's; the launches of the eager calls and the capture;
    eager and captured ms per step, CUDA API calls per captured step
    (profiled as ``[graphs]`` profiles them), peak memory and capture
    seconds. Saves the reference's first step (params and the checked
    steps' metrics) to ``ref_path`` for the spawned layouts."""
    cfg = Config.from_dict(HEADLINE)
    x_a, x_b = headline_batch("cuda")
    z_sample = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (N_MEMBERS, BATCH, cfg.gen.style_dim)).astype(np.float32))
    ref = _route_run(CouncilTrainer(cfg, device="cuda"), x_a, x_b, False,
                      z_sample, first_path=ref_path)
    torch.save({**torch.load(ref_path, weights_only=True),
                "metrics": ref["metrics"][:MULTI_STEPS]}, ref_path)
    gib = state_bytes(ref.pop("state")) / 2 ** 30
    check_train_launches(ref["launches"], MULTI_STEPS + 1,
                         "CouncilTrainer")
    runs = [("CouncilTrainer", float(np.median(ref["ms"][MULTI_STEPS:])))]
    log(f"[multi-gpu] CouncilTrainer: {MULTI_STEPS + MULTI_TIMED} eager "
        f"headline steps, the reference; ms per step "
        f"{[round(v, 6) for v in ref['ms']]}; its TrainState's parameters "
        f"and Adam moments {gib:.6g} GiB (each trainer below frees its "
        f"state before the next one's run) [{card_str}]")
    for name, make in (
            ("DataParallelTrainer", lambda: DataParallelTrainer(
                cfg, make_mesh(1), device="cuda")),
            ("CouncilShardTrainer", lambda: CouncilShardTrainer(
                cfg, make_mesh(1, always_2d=True), device="cuda"))):
        got = {}
        for route in ("eager", "captured"):
            trainer = make()
            run = _route_run(trainer, x_a, x_b, route == "captured",
                              z_sample)
            state = run.pop("state")
            check_train_launches(run["launches"], MULTI_STEPS + 1,
                                 f"{name} {route}")
            for key in ("payload", "mid_snapshot"):
                bad = payload_diff(run[key], ref[key])
                if bad:
                    raise AssertionError(
                        f"{name} {route} (NCCL world 1): {key} is not "
                        f"CouncilTrainer's eager one: {len(bad)} tensors "
                        f"differ {bad[:4]}")
            if run["metrics"] != ref["metrics"] or not torch.equal(
                    run["sample"], ref["sample"]):
                raise AssertionError(
                    f"{name} {route} (NCCL world 1): metrics equal "
                    f"{run['metrics'] == ref['metrics']}, sample equal "
                    f"{torch.equal(run['sample'], ref['sample'])}")
            step_fn = run.pop("step") or trainer.train_step
            if route == "captured":
                run["captures"] = [round(v, 6) for v in
                                   step_fn.capture_seconds.values()]
                run["replays"] = sum(c.replays for c, _ in
                                     step_fn.calls.values())
            if route == "captured":
                # the eager step's API calls: [graphs]'s profile of
                # CouncilTrainer's, plus the collectives' launches
                run["profile"] = route_profile(
                    lambda: step_fn(state, x_a, x_b), 1)
            got[route] = run
            del trainer, state, step_fn, run
        # the graphs' pool went with the compiled step: give it back
        torch.cuda.empty_cache()
        eager, graph = got["eager"], got["captured"]
        e_ms = float(np.median(eager["ms"][MULTI_STEPS:]))
        g_ms = float(np.median(graph["ms"][MULTI_STEPS + 1:]))
        runs.append((name, e_ms, g_ms))
        log(f"[multi-gpu] {name} (NCCL world 1): {MULTI_STEPS} eager "
            f"calls then {graph['replays']} replays of compile_step "
            f"(captures s {graph['captures']}), and "
            f"{MULTI_STEPS + MULTI_TIMED} eager steps: every metric, "
            f"parameter, buffer and Adam moment, the sample and the "
            f"snapshot between replays bit-equal to each other and to "
            f"CouncilTrainer's eager steps; launch invariants held (eager "
            f"calls and the capture); ms per step eager "
            f"{[round(v, 6) for v in eager['ms']]}, captured "
            f"{[round(v, 6) for v in graph['ms']]}: median {e_ms:.6g} vs "
            f"{g_ms:.6g} ms; CUDA API launch calls per captured step "
            f"{graph['profile']['api_launches']:.6g}; peak memory eager "
            f"{eager['peak'] / 2 ** 30:.6g} GiB, captured "
            f"{graph['peak'] / 2 ** 30:.6g} GiB [{card_str}]")
        log_route("train", f"{name} step captured", graph["profile"],
                  card_str, phase="multi-gpu")
    return runs


def serving_devices(n: int) -> list:
    """The first n cards, or cuda:0 named n times on a smaller machine."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def engine_ips(engine, images, reps: int) -> float:
    """Requests per second through ``engine``: one warm round of
    ``images``, then ``reps`` rounds."""
    for f in [engine.submit(im, seed=0) for im in images]:
        f.result(timeout=300)
    t0 = time.perf_counter()
    futures = [engine.submit(im, seed=i)
               for i, im in enumerate(np.concatenate([images] * reps))]
    for f in futures:
        f.result(timeout=300)
    return len(futures) / (time.perf_counter() - t0)


def engine_routes_ips(tr, params, images, all_members: bool,
                      reps: int) -> dict:
    """Requests per second through an engine over ``tr`` on each route:
    eager (``graphs`` set off, as an A/B of the default) and captured."""
    out = {}
    for route in ("eager", "captured"):
        engine = BatchingEngine(tr, params, (HW, HW), max_batch=BATCH,
                                max_delay_ms=200.0, all_members=all_members)
        engine.graphs = route == "captured"
        engine.start()
        try:
            engine.warmup()
            out[route] = engine_ips(engine, images, reps)
        finally:
            engine.stop()
    return out


def hold_sharded_call(tr, method: str, params, x, z, rng, where: str):
    """The layout's captured call at bucket BATCH (one graph per device)
    on ``(x, z)`` and on fresh inputs, each bit-equal to the eager call;
    the first result kept across the second call unchanged. -> the call
    and its capture seconds."""
    call = tr.captured(method, params, BATCH, (HW, HW))
    kept = call(torch.from_numpy(x), torch.from_numpy(z))
    first = getattr(tr, method)(params, x, z)
    x2 = rng.integers(0, 256, x.shape, dtype=np.uint8)
    z2 = rng.standard_normal(z.shape).astype(np.float32)
    second = call(torch.from_numpy(x2), torch.from_numpy(z2))
    if not torch.equal(second, getattr(tr, method)(params, x2, z2)):
        raise AssertionError(f"{where}: the replay differs from the eager "
                             f"call")
    if not torch.equal(kept, first):
        raise AssertionError(f"{where}: the first replay's result differs "
                             f"from the eager call, or changed at the "
                             f"next call")
    return call, call.capture_seconds


def multi_serve(card_str: str) -> list:
    """Phase 11's serving: each layout of SERVE_LAYOUTS (and D = 2 under
    w8a8_static) bit-equal to the one-device calls at the same per-shard
    bucket; its captured call (one graph per device) bit-equal to its
    eager call on two inputs with the first result kept unchanged; both
    routes profiled (API calls per call); then its engine's img/s at
    bucket BATCH, eager and captured."""
    cfg = Config.from_dict(FLAGSHIP)
    one = Translator(cfg, device="cuda")
    gens = one.init_members(N_MEMBERS, seed=0)
    sds = [g.state_dict() for g in gens]
    rng = np.random.default_rng(12)
    x = rng.integers(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
    z = rng.standard_normal((BATCH, cfg.gen.style_dim)).astype(np.float32)
    # member 0's calibration for the static int8 mode, on the card
    calib = one.make_gen(quant="w8a8_calib")
    calib.load_state_dict(sds[0], strict=True)
    stats = port_quant_stats_to_tree(calibrate(
        one, calib, [rng.uniform(-1, 1, (BATCH, HW, HW, 3))
                     .astype(np.float32)], num_style=2, seed=0), cfg)
    del calib
    # the one-device engines at the same bucket, beside the layouts
    out = []
    for name, params, all_members in (
            ("Translator (one device), member 0", gens[0], False),
            ("Translator (one device), all members", gens, True)):
        engine = BatchingEngine(one, params, (HW, HW), max_batch=BATCH,
                                max_delay_ms=200.0, all_members=all_members)
        engine.start()
        try:
            engine.warmup()
            ips = engine_ips(engine, x, reps=2 if all_members else 8)
        finally:
            engine.stop()
        name += " (captured)" if engine.graphs else " (eager)"
        images = ips * (N_MEMBERS if all_members else 1)
        out.append((name, ips, images))
        log(f"[multi-gpu] {name}: engine at bucket {BATCH}: {ips:.6g} "
            f"requests/s = {images:.6g} images/s [{card_str}]")
    del gens
    for name, d, k in SERVE_LAYOUTS + (
            ("ShardedTranslator D=2 w8a8_static", 2, 1),):
        quant = "w8a8_static" if "w8a8" in name else "none"
        qcfg = Config.from_dict({**FLAGSHIP, "quant": quant})
        qstats = stats if quant != "none" else None
        devices = serving_devices(d * k)
        if k == 1:
            tr = ShardedTranslator(qcfg, devices, quant_stats=qstats)
            ref = Translator(qcfg, quant_stats=qstats, device="cuda")
            members, gens = tr.load_members(sds), ref.load_members(sds)
            reset_counts()
            got = tr.translate_u8io_device(members, x, z=z, member=0)
            torch.cuda.synchronize()
            q1, q2 = conv_int8.launches, quantize_act.launches
            n = BATCH // d
            want = torch.cat([ref.translate_u8io_device(
                gens, x[i * n:(i + 1) * n], z=z[i * n:(i + 1) * n],
                member=0).to(got.device) for i in range(d)])
            params, all_members = members[0], False
            method = "translate_u8io_device"
        else:
            tr = MemberShardedTranslator(qcfg, make_member_mesh(
                k, devices=devices))
            ref = Translator(qcfg, device="cuda")
            members, gens = tr.load_members(sds), ref.load_members(sds)
            got = tr.translate_all_u8io_device(members, x, z)
            want = ref.translate_all_u8io_device(gens, x, z).to(got.device)
            params, all_members = members, True
            method = "translate_all_u8io_device"
        if not torch.equal(got, want):
            diff = (got.int() - want.int()).abs()
            raise AssertionError(f"{name}: differs from the one-device "
                                 f"calls by up to {int(diff.max())} levels")
        if quant != "none" and (q1 < 1 or q2 < 1):
            raise AssertionError(f"{name}: Q1/Q2 launches {q1}/{q2}")
        del gens, ref
        call, cap_s = hold_sharded_call(tr, method, params, x, z, rng, name)
        xt, zt = torch.from_numpy(x).pin_memory(), torch.from_numpy(z)
        prof = {"eager": route_profile(
            lambda: getattr(tr, method)(params, xt, zt), GRAPH_PROFILED),
            "captured": route_profile(lambda: call(xt, zt), GRAPH_PROFILED)}
        del call
        ips = engine_routes_ips(tr, params, x, all_members,
                                reps=8 if k == 1 else 2)
        tr.close()
        del tr, members, params
        torch.cuda.empty_cache()
        per = N_MEMBERS if all_members else 1
        names = ",".join(str(dv) for dv in devices)
        out.append((name, ips["captured"], ips["captured"] * per))
        log(f"[multi-gpu] {name} over [{names}]: bit-equal to the "
            f"one-device calls at bucket {BATCH // d} per shard"
            + (f" (Q1 {q1}, Q2 {q2} launches in the call)"
               if quant != "none" else "")
            + f"; captured ({d * k} graphs, capture {cap_s:.6g} s) "
            f"bit-equal to the eager call on two inputs, the first result "
            f"kept unchanged by the next call; CUDA API launch calls per "
            f"call eager {prof['eager']['api_launches']:.6g}, captured "
            f"{prof['captured']['api_launches']:.6g}; engine at bucket "
            f"{BATCH}: eager {ips['eager']:.6g} requests/s = "
            f"{ips['eager'] * per:.6g} images/s, captured "
            f"{ips['captured']:.6g} requests/s = "
            f"{ips['captured'] * per:.6g} images/s [{card_str}]")
        for route, r in prof.items():
            log_route("serve", f"{name} call (host x, z) {route}", r,
                      card_str, phase="multi-gpu")
    return out


def _multi_rank(rank: int, world: int, council: int, store: str,
                ref_path: str, out_path: str, loop_dir) -> None:
    """One spawned NCCL rank of a MULTI_LAYOUTS layout (trainer from
    ``train.loop.make_trainer``): MULTI_STEPS + MULTI_TIMED headline steps
    eagerly, then as many from the same weights with the compiled step
    (:func:`_route_run`, its eager sample and snapshot between replays).
    Rank 0 writes the eager checked steps' metrics, every step's ms on
    both routes, the first step's largest parameter difference to the
    one-process step and the ranks where the compiled run's state,
    metrics or sample differ from the eager run's (over all ranks). With
    ``loop_dir``: then ``train.loop.train`` for LOOP_STEPS on synthetic
    data with sample sheets and snapshots on the compiled step, whose
    summary rank 0 writes too."""
    # a rank that hangs (a collective no peer meets) prints every thread's
    # stack and exits, so the phase fails rather than run to its limit
    faulthandler.dump_traceback_later(SPAWN_LIMIT_S, exit=True)
    torch.cuda.set_device(rank)
    # the main process's settings (a spawned rank starts from defaults)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        cfg = Config.from_dict({**HEADLINE, "num_devices": world,
                                "council_parallel": council})
        x_a, x_b = headline_batch(f"cuda:{rank}")
        runs = {}
        for route in ("eager", "captured"):
            trainer = make_trainer(cfg, device=f"cuda:{rank}")
            b = BATCH // trainer.data_size
            rows = slice(trainer.data_index * b, (trainer.data_index + 1) * b)
            z_sample = torch.from_numpy(np.random.default_rng(13)
                                        .standard_normal(
                                            (N_MEMBERS, b,
                                             cfg.gen.style_dim))
                                        .astype(np.float32))
            first = f"{out_path}.{rank}.first.pt"
            run = _route_run(trainer, x_a[rows], x_b[rows],
                             route == "captured", z_sample,
                             first_path=first if route == "eager" else None)
            # the graphs go now: destroying the process group would wait
            # for every graph that holds one of its collectives
            run.pop("step")
            run["local"] = run.pop("state").snapshot()
            if route == "eager":
                run["param_diff"] = max_param_diff(
                    torch.load(first, weights_only=True)["params"],
                    torch.load(ref_path, weights_only=True)["params"],
                    trainer.member_offset)
            runs[route] = run
            del trainer, run
            torch.cuda.empty_cache()
        eager, graph = runs["eager"], runs["captured"]
        bad = (payload_diff(graph["local"], eager["local"])
               + (["metrics"] if graph["metrics"] != eager["metrics"] else [])
               + ([] if torch.equal(graph["sample"], eager["sample"])
                  else ["sample"]))
        got = [None] * world
        dist.all_gather_object(got, (eager["param_diff"], bad))
        summary = None
        if loop_dir:
            summary = train_loop.train(
                Config.from_dict({**HEADLINE, "num_devices": world,
                                  "council_parallel": council,
                                  **LOOP_CADENCE}), output_path=loop_dir, run_name="loop", synthetic=True,
                max_steps=LOOP_STEPS, device=f"cuda:{rank}")
        if rank == 0:
            torch.save({"metrics": eager["metrics"][:MULTI_STEPS],
                        "ms": eager["ms"], "graph_ms": graph["ms"],
                        "param_diff": max(d for d, _ in got),
                        "differ": {r: b for r, (_, b) in enumerate(got)
                                   if b}, "loop": summary}, out_path)
    finally:
        multihost.shutdown()
        faulthandler.cancel_dump_traceback_later()


def multi_train_spawned(card_str: str, ref_path: str, tmp: str,
                        world1: dict) -> list:
    """Each MULTI_LAYOUTS layout this machine has the cards for, as spawned
    NCCL ranks: the eager steps against the one-process reference, the
    compiled step bit-equal to the eager one; img/s beside the one-process
    captured step's (``world1``: CouncilShardTrainer's median ms at world
    1). The K=2 layout also runs the train loop on the compiled step."""
    ref = torch.load(ref_path, weights_only=True)
    out = []
    for name, world, council in MULTI_LAYOUTS:
        if torch.cuda.device_count() < world:
            continue
        store = os.path.join(tmp, f"store-{world}-{council}")
        res = os.path.join(tmp, f"multi-{world}-{council}.pt")
        loop_dir = os.path.join(tmp, "loop") if name == "K=2" else None
        mp.spawn(_multi_rank, args=(world, council, store, ref_path, res,
                                    loop_dir), nprocs=world, join=True)
        got = torch.load(res, weights_only=True)
        for step, (m, w) in enumerate(zip(got["metrics"], ref["metrics"])):
            for key in w:
                if abs(m[key] - w[key]) > MULTI_ATOL + MULTI_RTOL * abs(
                        w[key]):
                    raise AssertionError(f"{name} step {step + 1}: {key} "
                                         f"{m[key]} vs {w[key]}")
        if got["param_diff"] > MULTI_PARAM_TOL:
            raise AssertionError(f"{name}: parameters {got['param_diff']} "
                                 f"from the one-process step")
        if got["differ"]:
            raise AssertionError(f"{name}: the compiled step is not the "
                                 f"eager step on ranks {got['differ']}")
        e_ms = float(np.median(got["ms"][MULTI_STEPS:]))
        g_ms = float(np.median(got["graph_ms"][MULTI_STEPS + 1:]))
        ips = {"eager": BATCH / (e_ms / 1e3), "captured": BATCH / (g_ms / 1e3)}
        out.append((name, ips))
        loop_line = ""
        if got["loop"] is not None:
            lp = got["loop"]
            if not lp["graphs"] or lp["step"] != LOOP_STEPS:
                raise AssertionError(f"{name} loop: {lp}")
            loop_line = (f"; train.loop on the compiled step, {LOOP_STEPS} "
                         f"steps with sample sheets and snapshots "
                         f"({LOOP_CADENCE}) between replays on every rank: "
                         f"ended at step {lp['step']}, captures s "
                         f"{[round(v, 6) for v in lp['capture_seconds']]}, "
                         f"{lp['images_per_sec']:.6g} img/s over its last "
                         f"log window")
        log(f"[multi-gpu] {name} on {world} cards: {MULTI_STEPS} eager "
            f"headline steps within rtol {MULTI_RTOL} / atol {MULTI_ATOL} "
            f"of the one-process metrics, parameters within "
            f"{got['param_diff']:.3g} after step 1; the compiled step "
            f"({MULTI_STEPS} eager calls, then replays, a sample and a "
            f"snapshot between two) bit-equal to the eager step on every "
            f"rank; ms per step eager {[round(v, 6) for v in got['ms']]}, "
            f"captured {[round(v, 6) for v in got['graph_ms']]}: median "
            f"{e_ms:.6g} vs {g_ms:.6g} ms = {ips['eager']:.6g} vs "
            f"{ips['captured']:.6g} img/s, {ips['eager'] / world1['eager']:.4g}x"
            f" / {ips['captured'] / world1['captured']:.4g}x the one-process "
            f"step's img/s on its route{loop_line} [{card_str}]")
    return out


def phase_multi_gpu(card_str: str) -> None:
    """Phase 11 (see the module docstring)."""
    count = torch.cuda.device_count()
    ran = [name for name, world, _ in MULTI_LAYOUTS if count >= world]
    skipped = [name for name, world, _ in MULTI_LAYOUTS if count < world]
    serve_on = ("distinct cards where the machine has them, else cuda:0 "
                "named D or K times")
    log(f"[multi-gpu] device_count={count}; captured (compile_step) and "
        f"eager: NCCL world 1 DataParallelTrainer and CouncilShardTrainer"
        f"(D=1,K=1); serving {', '.join(n for n, _, _ in SERVE_LAYOUTS)} "
        f"and D=2 w8a8_static over {serve_on}, one graph per device; "
        f"spawned NCCL ranks: {', '.join(ran) or 'none'}"
        + (" (K=2 also through train.loop)" if "K=2" in ran else "")
        + (f"; not run: {', '.join(skipped)} (each needs its ranks' "
           f"cards, this machine has {count})" if skipped else ""))
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1)
        try:
            ref_path = os.path.join(tmp, "reference.pt")
            runs = multi_train_world1(card_str, ref_path)
            t1 = time.perf_counter()
            multi_serve(card_str)
            log(f"[multi-gpu] world-1 trainers {t1 - t0:.6g} s, serving "
                f"{time.perf_counter() - t1:.6g} s")
        finally:
            multihost.shutdown()
            torch.backends.cudnn.deterministic = deterministic
        # CouncilShardTrainer at world 1, the spawned layouts' yardstick
        e_ms, g_ms = dict((r[0], r[1:]) for r in runs)["CouncilShardTrainer"]
        multi_train_spawned(card_str, ref_path, tmp, {
            "eager": BATCH / (e_ms / 1e3), "captured": BATCH / (g_ms / 1e3)})
    log(f"[multi-gpu] phase {time.perf_counter() - t0:.6g} s")


# phase 12: steps after the 2 bit-compared ones, warm and timed; the
# discriminators' stateful norms; card vs CPU tolerances of their forward
# (f32: other conv algorithms, TF32 off, through 5 layers; bf16: 8
# significant bits over 5 rounded layers) and of their state after one
# training-mode forward (f32 rounding of the same sums in another order)
COMPLETE_WARM, COMPLETE_TIMED = 2, 5
DIS_NORMS = ("sn", "bn")
DIS_F32_REL, DIS_BF16_REL, DIS_STATE_TOL = 1e-4, 5e-2, 1e-5
VGG_SEED = 12


def write_random_vgg(path: str, seed: int = VGG_SEED) -> str:
    """A seeded random VGG16 in the JAX package's ``.npz`` layout (what
    ``vgg_model_path`` names; random weights price the loss, they do not
    make it meaningful)."""
    save_vgg_npz(path, init_random_vgg(torch.Generator().manual_seed(seed)))
    return path


def _timed_steps(trainer, state, x_a, x_b):
    """COMPLETE_WARM + COMPLETE_TIMED steps -> (state, the timed steps'
    metrics, their median ms, the peak memory over all of them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _, _ = host_steps(trainer, state, x_a, x_b, COMPLETE_WARM)
    state, metrics, ms = host_steps(trainer, state, x_a, x_b, COMPLETE_TIMED)
    return (state, metrics, float(np.median(ms)),
            torch.cuda.max_memory_allocated())


def vgg_device_ms(trainer, state, x_a, reps: int = 3) -> float:
    """Median device ms of the VGG loss of one step on its own: the
    members' translations of ``x_a`` in, the loss's forward (the input's
    features once, each member's) and its backward to the translations,
    between two CUDA events."""
    cfg = trainer.cfg
    with torch.no_grad():
        z = torch.randn((trainer.n, BATCH, cfg.gen.style_dim),
                        generator=torch.Generator().manual_seed(0))
        x_in = x_a.to(trainer.dtype)
        x_t = trainer._translate_members(state.gen["a2b"], x_in,
                                         z.to("cuda", trainer.dtype))[0]
    times = []
    for _ in range(reps + 1):
        x = x_t.detach().requires_grad_(True)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with torch.no_grad():
            target = vgg_target_features(trainer.vgg, x_in)
        loss = sum(compute_vgg_loss(trainer.vgg, x_i, x_in, target)
                   for x_i in x)
        loss.backward()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def dis_norm_check(norm: str, card_str: str) -> None:
    """Phase 12 (e): MsImageDis with ``norm`` at the headline width (dim 64,
    4 layers, 3 scales, 256px, batch 8) on the card against the same module
    on the CPU: one training-mode forward in f32 (logits, then ``u`` or the
    running statistics, which that forward updated), then an eval-mode
    forward of another batch in f32 and in bf16."""
    d = HEADLINE["dis"]
    cpu = MsImageDis(3, d["dim"], d["n_layer"], norm=norm,
                     num_scales=d["num_scales"])
    init_parameters(cpu, "gaussian", torch.Generator().manual_seed(12))
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(12)
    xs = [torch.from_numpy(rng.uniform(-1, 1, (BATCH, HW, HW, 3))
                           .astype(np.float32)) for _ in range(2)]

    def rel_err(got, want):
        return max(float((g.float().cpu() - w).abs().max())
                   / float(w.abs().max()) for g, w in zip(got, want))

    with torch.no_grad():
        errs = {"train f32": rel_err(gpu(xs[0].cuda()), cpu(xs[0]))}
        state = {k: float((v.float().cpu() - cpu.state_dict()[k].float())
                          .abs().max())
                 for k, v in gpu.state_dict().items()
                 if k.endswith(("weight_u", "running_mean", "running_var"))}
        cpu.eval()
        gpu.eval()
        want = cpu(xs[1])
        errs["eval f32"] = rel_err(gpu(xs[1].cuda()), want)
        errs["eval bf16"] = rel_err(gpu(xs[1].cuda().bfloat16()), want)
    worst = max(state, key=state.get)
    log(f"[complete] (e) MsImageDis norm={norm} (dim {d['dim']}, "
        f"{d['n_layer']} layers, {d['num_scales']} scales, {HW}px, batch "
        f"{BATCH}) card vs CPU f32, max error / max |logit|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerances {DIS_F32_REL} f32, {DIS_BF16_REL} bf16); state "
        f"after one training forward: {len(state)} tensors, worst {worst} "
        f"{state[worst]:.3g} (tolerance {DIS_STATE_TOL}) [{card_str}]")
    if (errs["train f32"] > DIS_F32_REL or errs["eval f32"] > DIS_F32_REL
            or errs["eval bf16"] > DIS_BF16_REL
            or state[worst] > DIS_STATE_TOL):
        raise AssertionError(f"dis norm={norm}: card vs CPU {errs}, state "
                             f"{worst} {state[worst]}")


def phase_complete(card_str: str, tmp: str) -> None:
    """Phase 12 (``[complete]``, after phase 8, in its directory): the
    JAX package's last features on the card. (a) ``remat_stages``: 2
    headline steps bit-equal to the plain step's from the same weights,
    batch and z (cuDNN deterministic for the phase), the recompute's launch
    invariant (:func:`remat_stage_launches`), then warm and timed steps of
    both: ms per step and peak memory, which must fall. (b) ``vgg_w: 1``
    with a seeded random VGG16 ``.npz`` under ``build/``: warm and timed
    steps, every metric finite, ``loss_gen_vgg_a2b`` > 0, ms per step and
    peak memory beside the plain step's, the loss's own device ms. (c)
    phase 7's reduced config with both options, card vs CPU at phase 7's
    tolerances. (d) ``tools.export_pt`` on phase 8's step-8 snapshot: the
    three files, and member 0 served from ``gen_*.pt`` through
    ``build_engine`` bit-equal to member 0 served from the snapshot at
    bucket 8. (e) :func:`dis_norm_check` for ``sn`` and ``bn``."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        vgg_path = write_random_vgg(os.path.join(tmp, "vgg16_random.npz"))
        x_a, x_b = headline_batch("cuda")
        sds = CouncilTrainer(Config.from_dict(HEADLINE), device="cpu"
                             ).init_state(seed=0).state_dicts()
        runs = {}
        for name, over in (("plain", {}),
                           ("remat_stages", {"remat_stages": True}),
                           ("vgg_w", {"vgg_w": 1.0,
                                      "vgg_model_path": vgg_path})):
            trainer = CouncilTrainer(Config.from_dict({**HEADLINE, **over}),
                                     device="cuda")
            state = trainer.load_state(sds, seed=0)
            run = {}
            if name != "vgg_w":
                reset_counts()
                state, run["metrics"], run["ms"] = host_steps(
                    trainer, state, x_a, x_b, MULTI_STEPS)
                run["launches"] = _snapshot()
                run["payload"] = trainer.snapshot(state)
            reset_counts()
            state, timed, run["median"], run["peak"] = _timed_steps(
                trainer, state, x_a, x_b)
            run["timed_launches"] = _snapshot()
            if not all(np.isfinite(list(m.values())).all() for m in timed):
                raise AssertionError(f"{name}: non-finite metrics {timed}")
            if name == "vgg_w":
                run["vgg_loss"] = [m["loss_gen_vgg_a2b"] for m in timed]
                run["vgg_ms"] = vgg_device_ms(trainer, state, x_a)
            runs[name] = run
            del trainer, state
            torch.cuda.empty_cache()
        plain, remat, vgg = runs["plain"], runs["remat_stages"], runs["vgg_w"]
        check_train_launches(plain["launches"], MULTI_STEPS, "plain")
        steps = COMPLETE_WARM + COMPLETE_TIMED
        for name in ("plain", "vgg_w"):
            check_train_launches(runs[name]["timed_launches"], steps, name)
        if remat["timed_launches"] != remat_stage_launches(
                plain["timed_launches"], steps):
            raise AssertionError(f"remat_stages launches over {steps} steps "
                                 f"{remat['timed_launches']}")
        want = remat_stage_launches(plain["launches"], MULTI_STEPS)
        bad = payload_diff(remat["payload"], plain["payload"])
        log(f"[complete] (a) remat_stages: {MULTI_STEPS} headline steps "
            f"{'bit-equal' if not bad else 'NOT bit-equal'} to the plain "
            f"step's (every parameter, Adam moment and metric; {len(bad)} "
            f"tensors differ); launches {json.dumps(remat['launches'])}, "
            f"the invariant (forward launches twice the plain step's, "
            f"backward the same) {'held' if remat['launches'] == want else 'FAILED'}")
        if bad or remat["metrics"] != plain["metrics"]:
            raise AssertionError(f"remat_stages is not the plain step: "
                                 f"{bad[:4]}")
        if remat["launches"] != want:
            raise AssertionError(f"remat_stages launches "
                                 f"{remat['launches']} != {want}")
        log(f"[complete] (a) then {COMPLETE_WARM} warm + {COMPLETE_TIMED} "
            f"timed steps each (launches over them: phase 6's invariants "
            f"for plain and vgg_w, twice the forwards for remat_stages): "
            f"median ms/step plain {plain['median']:.6g}, "
            f"remat_stages {remat['median']:.6g} "
            f"({remat['median'] / plain['median']:.4g}x); peak memory plain "
            f"{plain['peak'] / 2 ** 30:.6g} GiB, remat_stages "
            f"{remat['peak'] / 2 ** 30:.6g} GiB "
            f"({remat['peak'] / plain['peak']:.4g}x) [{card_str}]")
        if remat["peak"] >= plain["peak"]:
            raise AssertionError("remat_stages did not lower the peak memory")
        if min(vgg["vgg_loss"]) <= 0:
            raise AssertionError(f"loss_gen_vgg_a2b {vgg['vgg_loss']}")
        log(f"[complete] (b) vgg_w 1 (random VGG16 {vgg_path}): "
            f"{COMPLETE_WARM} warm + {COMPLETE_TIMED} timed steps, every "
            f"metric finite, loss_gen_vgg_a2b "
            f"{[round(v, 6) for v in vgg['vgg_loss']]}; median ms/step "
            f"{vgg['median']:.6g} ({vgg['median'] / plain['median']:.4g}x "
            f"plain), peak memory {vgg['peak'] / 2 ** 30:.6g} GiB "
            f"({vgg['peak'] / plain['peak']:.4g}x plain); the VGG loss's "
            f"own device ms per step (forward and backward, {N_MEMBERS} "
            f"members + the input, CUDA events) {vgg['vgg_ms']:.6g} "
            f"[{card_str}]")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    phase_train_accuracy(card_str, {"vgg_w": 1.0, "vgg_model_path": vgg_path,
                                    "remat_stages": True},
                         tag="[complete] (c) vgg_w 1 + remat_stages, reduced "
                         "config:")
    export_check(card_str, tmp)
    for norm in DIS_NORMS:
        dis_norm_check(norm, card_str)


def export_check(card_str: str, tmp: str) -> None:
    """Phase 12 (d): ``tools.export_pt`` on phase 8's last snapshot, and
    member 0 served from the exported ``gen_*.pt`` and from the snapshot
    through ``build_engine``, bit-equal at bucket 8."""
    cfg_path = os.path.join(tmp, "headline.yaml")
    end = CLI_STEPS + CLI_RESUME_STEPS
    snap = os.path.join(tmp, "runs", "headline", "checkpoints",
                        f"step_{end:08d}")
    out = os.path.join(tmp, "export")
    t0 = time.perf_counter()
    files = export_pt.main(["--config", cfg_path, "--checkpoint", snap,
                            "--out", out])
    seconds = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    want = sorted(f"{n}_{end:08d}.pt" for n in ("gen", "dis",
                                                 "dis_council"))
    if names != want:
        raise AssertionError(f"export wrote {names}, want {want}")
    cfg = Config.from_dict(HEADLINE)
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)
    z = rng.standard_normal((BATCH, cfg.gen.style_dim)).astype(np.float32)
    outs = []
    for ckpt in (snap, files["gen"]):
        engine = build_engine(cfg, ckpt, "0", "a2b", max_batch=BATCH,
                              max_delay_ms=200.0, warmup=False,
                              device="cuda")
        try:
            outs.append(engine.translator.translate_u8io(
                engine.params, images, z=z))
        finally:
            engine.stop()
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError("member 0 from the exported gen .pt differs "
                             "from the snapshot's")
    log(f"[complete] (d) export_pt of {snap}: {names} "
        f"({sum(os.path.getsize(os.path.join(out, n)) for n in names)} "
        f"bytes) in {seconds:.6g} s; member 0 through build_engine from "
        f"the exported gen .pt bit-equal to the snapshot's at bucket "
        f"{BATCH} [{card_str}]")


# [graphs]: the serving buckets and the train step as captured CUDA graphs
# (councilx_torch/utils/graphs.py), every replay held bit-equal to the
# eager call. The quantized serving settings; the headline step's eager
# warm-up calls and replays; the calls profiled per route; the train
# settings held step for step beside it: (name, overrides, steps), each
# with one eager warm-up call per step shape.
GRAPH_QUANT = (("w8a8", "resblocks"), ("w8a8_static", "resblocks"),
               ("w8a8", "heavy"), ("w8a8_static", "heavy"))
GRAPH_WARM, GRAPH_REPLAYS = 2, 10
GRAPH_PROFILED = 2
GRAPH_TRAIN = (
    # the council gate opens at step 3 (a replay), the council weight
    # ramps over steps 3-4, recon_x_w and mask_total_w anneal throughout
    ("scheduled", {
        "recon_x_w": {"base": 10.0, "anneal": "linear",
                      "anneal_start_iter": 0, "anneal_iters": 5,
                      "end_value": 2.0},
        "council": {"council_size": 4, "council_start_at_iter": 3,
                    "council_w": {"base": 0.2, "start_at_iter": 3,
                                  "warmup_iters": 2}},
        "focus_loss": {"focus_enabled": True, "focus_start_at_iter": 2,
                       "mask_total_w": {"base": 0.005, "anneal": "cosine",
                                        "anneal_start_iter": 1,
                                        "anneal_iters": 4,
                                        "end_value": 0.001}}}, 5),
    # two graphs: steps 0 and 1 eager, 2 and 3 captured, 4 and 5 replayed
    ("every_kth", {"council": {"council_size": 4, "council_w": 0.2,
                               "council_dis_relative_iteration": 2,
                               "cdis_ratio_mode": "every_kth"}}, 6),
    ("remat_stages", {"remat_stages": True}, 4),
)
# vgg_w: 1's calls: the warm-up, the capture, one more replay
GRAPH_VGG_STEPS = 3


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def route_profile(fn, calls: int) -> dict:
    """Per call of ``fn`` (after one warm call): wall ms (host clock around
    ``calls`` calls and a synchronize), host enqueue ms (median of one
    call, no synchronize), and from a torch.profiler trace of ``calls``
    more: kernel ms (the sum of the trace's CUDA events' durations:
    kernels, copies, sets) and device ops, CUDA API launch calls (the
    trace's runtime and driver launches: kernels, cooperative kernels,
    graphs), and the device's busy share: the time at least one device
    op runs (the union of their intervals) over the wall time. The trace
    is taken again, up to twice, if it holds no device event."""
    fn()
    torch.cuda.synchronize()
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(calls):
        e0 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - e0)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / calls
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans, api = [], 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
            elif e.name.startswith("cu") and "Launch" in e.name:
                api += 1
        if spans:
            kernel = sum(b - a for a, b in spans) / 1e3 / calls
            return {"wall_ms": wall,
                    "enqueue_ms": 1e3 * float(np.median(enqueue)),
                    "kernel_ms": kernel, "device_ops": len(spans) / calls,
                    "api_launches": api / calls,
                    "busy": union_us(spans) / 1e3 / calls / wall}
    raise AssertionError("the profiler recorded no device event")


def log_route(tag: str, what: str, r: dict, card_str: str,
              phase: str = "graphs") -> None:
    log(f"[{phase}] {tag} {what}: wall {r['wall_ms']:.6g} ms, enqueue "
        f"{r['enqueue_ms']:.6g} ms, kernels {r['kernel_ms']:.6g} ms, "
        f"{r['device_ops']:.6g} device ops and {r['api_launches']:.6g} "
        f"CUDA API launch calls per call, device busy (some op running) "
        f"{100 * r['busy']:.4g}% of the wall [{card_str}]")


def _hold_captured(tr: Translator, method: str, params, bucket: int,
                   rng, where: str) -> float:
    """Capture ``method`` at ``bucket`` and hold two replays, on fresh
    inputs, bit-equal to the eager calls (every output: the GUI's methods
    give images and masks) -> the capture's seconds."""
    call = tr.captured(method, params, bucket, (HW, HW))
    zshape = (bucket, tr.cfg.gen.style_dim)
    if method == "translate_all_members":
        zshape = (len(params),) + zshape
    for _ in range(2):
        if "u8io" in method:
            x = rng.integers(0, 256, (bucket, HW, HW, 3), dtype=np.uint8)
        else:
            x = rng.uniform(-1, 1, (bucket, HW, HW, 3)).astype(np.float32)
        z = rng.standard_normal(zshape).astype(np.float32)
        got = call(torch.from_numpy(x), torch.from_numpy(z))
        want = getattr(tr, method)(params, x, z)
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        if not all(torch.equal(a.cpu(), b.cpu())
                   for a, b in zip(got, want)):
            raise AssertionError(f"[graphs] {where} bucket {bucket}: the "
                                 f"replay differs from the eager call")
    return call.capture_seconds


def graphs_serve(card_str: str) -> None:
    """The flagship serving model: member 0 at every bucket of the
    engine's ladder, all members and the float32 wire at bucket 8, and
    each W8A8 setting of GRAPH_QUANT at every bucket, captured and held
    bit-equal to eager; bucket 8 profiled on both routes."""
    from councilx_torch.inference.server import _bucket_ladder
    from councilx_torch.tools import calibrate_quant

    cfg = Config.from_dict(FLAGSHIP)
    buckets = _bucket_ladder(BATCH)
    rng = np.random.default_rng(15)
    tr = Translator(cfg, device="cuda")
    gens = tr.init_members(N_MEMBERS, seed=0)
    t0 = time.perf_counter()
    caps = {b: _hold_captured(tr, "translate_u8io_device", gens[0], b, rng,
                              "member 0") for b in buckets}
    log(f"[graphs] serve member 0: buckets {buckets} each captured (one "
        f"eager warm-up run, then the capture) and replayed bit-equal to "
        f"eager on two inputs in {time.perf_counter() - t0:.6g} s; "
        f"capture s per bucket {json.dumps(caps)} [{card_str}]")
    cap_all = _hold_captured(tr, "translate_all_u8io_device", gens, BATCH,
                             rng, "all members")
    cap_f32 = _hold_captured(tr, "translate_u8_device", gens[0], BATCH, rng,
                             "float32 wire")
    log(f"[graphs] serve all {N_MEMBERS} members and the float32 wire at "
        f"bucket {BATCH}: bit-equal; capture {cap_all:.6g} s and "
        f"{cap_f32:.6g} s [{card_str}]")
    caps = [_hold_captured(tr, method, params, 1, rng, f"gui {method}")
            for method, params in (("translate", gens[1]),
                                   ("translate_all_members", gens))]
    log(f"[graphs] gui renders (one image; images and masks): member 1 and "
        f"all members bit-equal; capture s {caps[0]:.6g} and {caps[1]:.6g} "
        f"[{card_str}]")
    x8 = torch.from_numpy(rng.integers(0, 256, (BATCH, HW, HW, 3),
                                       dtype=np.uint8)).cuda()
    z8 = torch.randn(BATCH, cfg.gen.style_dim).cuda()
    call = tr.captured("translate_u8io_device", gens[0], BATCH, (HW, HW))
    eager = route_profile(lambda: tr.translate_u8io_device(gens[0], x8,
                                                           z=z8), 5)
    graph = route_profile(lambda: call(x8, z8).clone(), 5)
    log_route("serve", f"bucket {BATCH} member 0 eager", eager, card_str)
    log_route("serve", f"bucket {BATCH} member 0 graph (copy in, replay, "
              "copy out)", graph, card_str)
    xh, zh = x8.cpu().numpy(), z8.cpu().numpy()
    host = {"eager": lambda: tr.translate_u8io_device(
        gens[0], xh, z=zh).cpu(),
        "graph": lambda: call(torch.from_numpy(xh),
                              torch.from_numpy(zh)).clone().cpu()}
    hw = {k: float(np.median(median_ms(f, reps=10))) for k, f in host.items()}
    log(f"[graphs] serve bucket {BATCH} host to host (pinned upload, "
        f"readback): eager {hw['eager']:.6g} ms, graph {hw['graph']:.6g} "
        f"ms per batch [{card_str}]")
    sd = gens[0].state_dict()
    del tr, gens, call
    torch.cuda.empty_cache()
    for mode, scope in GRAPH_QUANT:
        raw = {**FLAGSHIP, "quant_scope": scope}
        stats = None
        if mode == "w8a8_static":
            cal = Translator(Config.from_dict(raw), device="cuda")
            gen = cal.make_gen(quant="w8a8_calib")
            gen.load_state_dict(sd)
            qcfg = Config.from_dict(raw)
            stats = port_quant_stats_to_tree(calibrate_quant.calibrate(
                cal, gen, calibrate_quant.calibration_batches(
                    qcfg, None, BATCH, 2, 0), 2, 0), qcfg)
        tq = Translator(Config.from_dict({**raw, "quant": mode}),
                        quant_stats=stats, device="cuda")
        gq = tq.load_members([sd])[0]
        caps = {b: _hold_captured(tq, "translate_u8io_device", gq, b, rng,
                                  f"{mode} {scope}") for b in buckets}
        log(f"[graphs] serve {mode} {scope}: buckets {buckets} bit-equal; "
            f"capture s per bucket {json.dumps(caps)} [{card_str}]")
        del tq, gq
        torch.cuda.empty_cache()


def _steps(step_fn, state, x_a, x_b, n: int, snap_at=None):
    """``n`` calls of ``step_fn`` -> (state, metrics per step as floats,
    the state's snapshot after call ``snap_at``)."""
    metrics, snap = [], None
    for i in range(n):
        state, m = step_fn(state, x_a, x_b)
        metrics.append({k: float(v) for k, v in m.items()})
        if snap_at == i + 1:
            snap = state.snapshot()
    return state, metrics, snap


def _same_steps(name: str, over: dict, steps: int, warm: int, sds, x_a,
                x_b, card_str: str, resume_at=None) -> dict:
    """``steps`` eager steps, and from the same weights and z seed ``warm``
    - 1 eager steps then the compiled step (each step shape's first call
    eager) to ``steps``: every metric, parameter and Adam moment
    bit-equal. With ``resume_at``: the compiled run's snapshot at that step
    restored into a new trainer, compiled again and run to the end,
    bit-equal too."""
    cfg = Config.from_dict({**HEADLINE, **over})
    eager = CouncilTrainer(cfg, device="cuda")
    ref = eager.load_state(sds, seed=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref, want, _ = _steps(eager.train_step, ref, x_a, x_b, steps)
    torch.cuda.synchronize()
    out = {"eager_s": time.perf_counter() - t0,
           "eager_peak": torch.cuda.max_memory_allocated()}
    comp = CouncilTrainer(cfg, device="cuda")
    state = comp.load_state(sds, seed=5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, got, _ = _steps(comp.train_step, state, x_a, x_b, warm - 1)
    step = comp.compile_step(state)
    state, more, snap = _steps(step, state, x_a, x_b, steps - warm + 1,
                               None if resume_at is None
                               else resume_at - warm + 1)
    got += more
    torch.cuda.synchronize()
    out.update(graph_s=time.perf_counter() - t0,
               graph_peak=torch.cuda.max_memory_allocated(),
               launches=_snapshot(),
               captures={str(k[2]): round(v, 6) for k, v in
                         step.capture_seconds.items()},
               replays=sum(c.replays for c, _ in step.calls.values()))
    if got != want:
        bad = [(i, k) for i, (g, w) in enumerate(zip(got, want))
               for k in w if g.get(k) != w[k]]
        raise AssertionError(f"[graphs] {name}: metrics differ at {bad[:6]}")
    diff = payload_diff(state.snapshot(), ref.snapshot())
    if diff:
        raise AssertionError(f"[graphs] {name}: state differs at {diff[:6]}")
    if resume_at is not None:
        final = state.snapshot()
        out["profile"] = route_profile(
            lambda: step(state, x_a, x_b), GRAPH_PROFILED)
        out["eager_profile"] = route_profile(
            lambda: eager.train_step(ref, x_a, x_b), GRAPH_PROFILED)
        del step, state, ref
        torch.cuda.empty_cache()
        back = CouncilTrainer(cfg, device="cuda")
        s2 = back.restore_state(snap)
        s2, _, _ = _steps(back.compile_step(s2), s2, x_a, x_b,
                          steps - resume_at)
        diff = payload_diff(s2.snapshot(), final)
        if diff:
            raise AssertionError(f"[graphs] {name}: resumed at {resume_at} "
                                 f"and compiled again, the state differs "
                                 f"at {diff[:6]}")
    resumed = ("" if resume_at is None else
               f"; its snapshot at step {resume_at} restored into a new "
               f"trainer and compiled again: bit-equal at step {steps}")
    log(f"[graphs] {name}: {warm - 1} eager step(s), then the compiled "
        f"step (its first call per step shape eager; captures s "
        f"{json.dumps(out['captures'])}, {out['replays']} replays) to step "
        f"{steps}: bit-equal to {steps} eager steps in every metric, "
        f"parameter and Adam moment{resumed}; {out['eager_s']:.6g} s "
        f"eager, {out['graph_s']:.6g} s compiled (captures included); peak "
        f"memory eager {out['eager_peak'] / 2 ** 30:.6g} GiB, compiled "
        f"{out['graph_peak'] / 2 ** 30:.6g} GiB [{card_str}]")
    torch.cuda.empty_cache()
    return out


def graphs_train(card_str: str) -> None:
    """The headline step: GRAPH_WARM eager steps (the last the compiled
    step's warm-up call) and GRAPH_REPLAYS replays bit-equal to as many
    eager steps, the launches of the eager steps and the capture, a resume
    from its snapshot; both routes profiled; then each of GRAPH_TRAIN."""
    x_a, x_b = headline_batch("cuda")
    sds = CouncilTrainer(Config.from_dict(HEADLINE), device="cpu"
                         ).init_state(seed=0).state_dicts()
    steps = GRAPH_WARM + GRAPH_REPLAYS
    head = _same_steps("headline", {}, steps, GRAPH_WARM, sds, x_a, x_b,
                       card_str, resume_at=steps // 2)
    # the wrappers launch in the eager calls and record into the capture;
    # a replay calls no wrapper
    check_train_launches(head["launches"], GRAPH_WARM + 1, "[graphs]")
    if head["replays"] != GRAPH_REPLAYS:
        raise AssertionError(f"[graphs] {head['replays']} replays")
    log_route("train", "headline step eager", head["eager_profile"],
              card_str)
    log_route("train", "headline step graph", head["profile"], card_str)
    for name, over, n in GRAPH_TRAIN:
        _same_steps(name, over, n, 1, sds, x_a, x_b, card_str)
    # the heaviest step's peak under graphs: the f32 VGG16 loss
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        vgg = write_random_vgg(os.path.join(tmp, "vgg16_random.npz"))
        _same_steps("vgg_w", {"vgg_w": 1.0, "vgg_model_path": vgg},
                    GRAPH_VGG_STEPS, 1, sds, x_a, x_b, card_str)


def phase_graphs(card_str: str) -> None:
    """The [graphs] phase (module docstring, 14.), cuDNN deterministic for
    its bit-equality checks (the discriminators' convs)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        graphs_serve(card_str)
        graphs_train(card_str)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[graphs] phase {time.perf_counter() - t0:.6g} s")


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
    kres.update(quant_cases(g, card_str))

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        ckpt, none_tp = phase_serve(card_str, tmp)
        phase_accuracy(ckpt, card_str)
        phase_eval(card_str, tmp, ckpt)
        quant_launches = phase_quant(card_str, tmp, ckpt, none_tp)
    launches, step_ips = phase_train(card_str)
    phase_train_accuracy(card_str)
    engines = phase_engines(card_str)
    phase_graphs(card_str)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cli_launches = phase_train_cli(card_str, tmp, step_ips)
        phase_complete(card_str, tmp)
    phase_multi_gpu(card_str)

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
        ("conv_int8", "cuda", "councilx_torch/csrc/conv_int8.cu",
         "councilx/ops/quant.py:95", quant_launches["conv_int8.launches"],
         kres[("conv_int8", "resblock")]),
        ("quant_act", "cuda", "councilx_torch/csrc/quant_act.cu",
         "councilx/ops/quant.py:65", quant_launches["quantize_act.launches"],
         kres[("quant_act", "resblock")]),
        ("quant_act_dynamic", "cuda", "councilx_torch/csrc/quant_act.cu",
         "councilx/ops/quant.py:56",
         quant_launches["quantize_act.per_image_launches"],
         kres[("quant_act_dynamic", "resblock")]),
        ("pad_nhwc", "cuda", "councilx_torch/csrc/pad_nhwc.cu",
         "councilx/nn/blocks.py:95", launches["pad_nhwc.launches"],
         kres[("pad_nhwc", "bf16", main_shape)]),
        ("pad_fold", "cuda", "councilx_torch/csrc/pad_nhwc.cu",
         "councilx/nn/blocks.py:95", launches["pad_fold.launches"],
         kres[("pad_fold", "bf16", main_shape)]),
    ]
    # K1/K1'/K2 at the engines' shapes; launches: the kernel's count in
    # the engines phase's run where the shape runs (a serving forward under
    # upsample_engine phase: 16 resblock convs and the 2 phase convs; the
    # timed steps under phase + resblock_fuse_pad, every resblock conv at
    # pad 1)
    conv_src = "councilx_torch/csrc/conv3x3.cu"
    wgrad_src = "councilx_torch/csrc/conv3x3_wgrad.cu"
    served = engines["serve"]["phase"]["launches"]
    trained = engines["train"]["phase+resblock_fuse_pad"]["launches"]
    for site, (b, h, w, c, o) in PHASE_CONV_SITES.items():
        tag = f"{site} phase conv"
        xp = (b, h + 2, w + 2, c)
        entries += [
            (f"conv3x3@{site}_phase", "cuda", conv_src,
             "councilx/ops/pallas_conv.py:82",
             served["conv3x3_valid.launches"],
             kres[("conv3x3", "bf16", f"{tag} xp {xp} -> {o}")]),
            (f"conv3x3_dgrad@{site}_phase", "cuda", conv_src,
             "councilx/ops/pallas_conv.py:279",
             trained["conv3x3_dgrad.launches"],
             kres[("conv3x3_dgrad", "bf16", f"{tag} g {(b, h, w, o)}")]),
            (f"conv3x3_wgrad@{site}_phase", "cuda", wgrad_src,
             "councilx/ops/pallas_conv.py:178",
             trained["conv3x3_wgrad.launches"],
             kres[("conv3x3_wgrad", "bf16", f"{tag} xp {xp}")])]
    x1 = PAD1_SITE[:4]
    entries += [
        ("conv3x3_same_zero", "cuda", conv_src,
         "councilx/ops/pallas_conv.py:82", trained["conv3x3_valid.launches"],
         kres[("conv3x3_same_zero", "bf16", f"pad 1 x {x1}")]),
        ("conv3x3_dgrad_pad1", "cuda", conv_src,
         "councilx/ops/pallas_conv.py:279",
         trained["conv3x3_dgrad.launches"],
         kres[("conv3x3_dgrad_pad1", "bf16",
               f"pad 1 g {PAD1_SITE[:3] + PAD1_SITE[4:]}")]),
        ("conv3x3_wgrad_pad1", "cuda", wgrad_src,
         "councilx/ops/pallas_conv.py:178",
         trained["conv3x3_wgrad.launches"],
         kres[("conv3x3_wgrad_pad1", "bf16", f"pad 1 x {x1}")])]
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
