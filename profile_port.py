#!/usr/bin/env python3
"""Where the time goes on councilx_torch's two main paths, on one GPU.

    python3 profile_port.py [--out DIR]

Imports nothing of JAX or ``councilx``; needs one CUDA card. The paths and
configs are ``chip_smoke.py``'s, with random weights from seed 0:

1. serving: member 0 of the flagship council-4 256px bf16 model at bucket
   8, through ``Translator.translate_u8io_device`` (uint8 in and out on
   the card), 3 warm calls, then 5 calls under ``torch.profiler``; then
   the same with W8A8 quantization: per image (``w8a8``) and static
   (``w8a8_static``, scales calibrated over 2 batches of seeded noise by
   ``councilx_torch.tools.calibrate_quant.calibrate``), in both the
   "resblocks" and the "heavy" scope;
2. training: ``CouncilTrainer.train_step`` at ``bench.py::headline_config``
   (council-4, 256px, batch 8, bf16), 3 warm steps, then 3 profiled steps.

For each path it prints the wall time per call (host clock around
synchronized work), the host time to enqueue one call, the device kernel
time per call (the sum of every kernel's duration in the trace), the
device ops and the CUDA API launch calls per call (the trace's device
events; its runtime and driver launch calls: kernels, cooperative
kernels, graphs) and the device's busy share (the time at least one
device op runs, the union of their intervals, over the wall time),
then the kernel time per call by class of kernel and the heaviest
kernels by name. ``--out DIR`` also writes the summaries to
DIR/profile.json.

``--engines`` profiles instead the generator's conv-engine settings of
``chip_smoke.py``'s engines phase: serving (1.) under each of
``chip_smoke.ENGINE_SERVE``, and the train step (2.) under each of
``chip_smoke.ENGINE_TRAIN``, unquantized.

``--graphs`` profiles the captured routes (``councilx_torch/utils/
graphs.py``) beside the eager ones: serving (1., unquantized) as the
engine's captured device call (the inputs copied into the bucket's static
buffers, the replay, the output copied out), and the train step (2.)
through ``CouncilTrainer.compile_step`` (its eager warm-up call, the
capture and one replay are the 3 warm calls); and for each graph the
host ms of one ``replay()`` launched right after a synchronize, while
the previous replay still runs and behind a ~0.5 s sleep kernel
(:func:`replay_host_ms`).
"""

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

import chip_smoke
from councilx_torch.config import Config
from councilx_torch.inference.translate import Translator
from councilx_torch.train.trainer import CouncilTrainer

# kernel classes, first match by substring of the kernel's name
CLASSES = (
    ("Q1 int8 conv (conv_int8.cu)", ("conv_int8_kernel",)),
    ("Q2 activation quantize (quant_act.cu)", ("quant_kernel",)),
    ("K1/K1' conv3x3 (conv3x3.cu)", ("conv3x3_bf16_kernel",
                                     "conv3x3_f32_kernel")),
    ("K2 wgrad (conv3x3_wgrad.cu)", ("wgrad_wgmma_kernel",
                                     "wgrad_f32_kernel",
                                     "sum_splits_kernel")),
    ("K5/K6 norm backward (CUDA, instance_norm_bwd.cu)",
     ("instance_norm_bwd_kernel",)),
    ("K3/K4 norm forward (CUDA, instance_norm_fwd.cu)",
     ("instance_norm_fwd_kernel",)),
    ("P1/P1' reflect pad and fold (pad_nhwc.cu)", ("pad_nhwc_kernel",
                                                   "pad_fold_kernel")),
    ("cuDNN / cuBLAS convs and matmuls", ("cudnn", "xmma", "gemm", "conv",
                                          "cutlass", "sm90_", "nchwTo",
                                          "nhwcTo", "wgrad_alg", "dgrad")),
    ("gather and scatter (pad, index, index_put)", ("index", "scatter",
                                                    "gather", "sort",
                                                    "radix", "pad")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat")),
    ("elementwise", ("elementwise", "foreach", "vectorized")),
)


def classify(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def kernel_table(prof, calls: int) -> dict:
    """Device ms per call by kernel name, from the trace's CUDA events;
    the CUDA API launch calls per call; the ms per call in which at least
    one device op runs (the union of their intervals)."""
    per_name = defaultdict(float)
    launches = defaultdict(int)
    api, spans = 0, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us() / 1e3 / calls
            launches[e.name] += 1
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cu") and "Launch" in e.name:
            api += 1
    return {"ms": dict(per_name),
            "launches": {k: v / calls for k, v in launches.items()},
            "api_launches": api / calls,
            "busy_ms": chip_smoke.union_us(spans) / 1e3 / calls}


def profile(fn, warm: int, calls: int, label: str) -> dict:
    """Wall, enqueue and kernel time per call of fn, and the breakdown."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(calls):
        e0 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - e0)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    table = kernel_table(prof, calls)
    kernel_ms = sum(table["ms"].values())
    by_class = defaultdict(float)
    for name, ms in table["ms"].items():
        by_class[classify(name)] += ms
    summary = {
        "path": label, "calls": calls, "wall_ms": wall_ms,
        "enqueue_ms": 1e3 * float(np.median(enqueue)),
        "kernel_ms": kernel_ms, "busy_share": table["busy_ms"] / wall_ms,
        "launches": sum(table["launches"].values()),
        "api_launches": table["api_launches"],
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": n[:120], "ms": ms, "launches": table["launches"][n]}
            for n, ms in sorted(table["ms"].items(),
                                key=lambda kv: -kv[1])[:25]]}
    print(f"[profile] {label}: wall {wall_ms:.6g} ms/call, enqueue "
          f"{summary['enqueue_ms']:.6g} ms, kernels {kernel_ms:.6g} ms "
          f"({summary['launches']:.6g} device ops, "
          f"{summary['api_launches']:.6g} API launch calls) per call, "
          f"device busy "
          f"{100 * summary['busy_share']:.4g}%", flush=True)
    for cls, ms in summary["by_class_ms"].items():
        print(f"[profile] {label}:   {ms:9.4f} ms  {100 * ms / kernel_ms:5.1f}%"
              f"  {cls}", flush=True)
    for k in summary["top_kernels"][:12]:
        print(f"[profile] {label}:   {k['ms']:9.4f} ms  x{k['launches']:g}  "
              f"{k['name']}", flush=True)
    return summary


def profile_quant(mode: str, scope: str, sd, x8, z8) -> dict:
    """The serving profile with the flagship's convs quantized as ``mode``
    in ``scope``, from the weights ``sd``."""
    from councilx_torch.ckpt.torch_convert import port_quant_stats_to_tree
    from councilx_torch.tools import calibrate_quant

    raw = {**chip_smoke.FLAGSHIP, "quant_scope": scope}
    stats = None
    if mode == "w8a8_static":
        cal = Translator(Config.from_dict(raw), device="cuda")
        gen = cal.make_gen(quant="w8a8_calib")
        gen.load_state_dict(sd)
        cfg = Config.from_dict(raw)
        stats = port_quant_stats_to_tree(calibrate_quant.calibrate(
            cal, gen, calibrate_quant.calibration_batches(
                cfg, None, chip_smoke.BATCH, 2, 0), 2, 0), cfg)
    tr = Translator(Config.from_dict({**raw, "quant": mode}),
                    quant_stats=stats, device="cuda")
    gen = tr.load_members([sd])[0]
    return profile(lambda: tr.translate_u8io_device(gen, x8, z=z8), 3, 5,
                   f"serve_bucket8_{mode}_{scope}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for profile.json, the summaries")
    ap.add_argument("--engines", action="store_true",
                    help="profile the conv-engine settings instead")
    ap.add_argument("--graphs", action="store_true",
                    help="profile the captured routes beside the eager")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    card = chip_smoke.card()
    print(f"[profile] {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}", flush=True)
    paths = (profile_engines() if args.engines else
             profile_graphs() if args.graphs else profile_paths())
    if args.out:
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump({"card": card, "paths": paths}, f, indent=1)
    print(card)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    b, hw = chip_smoke.BATCH, chip_smoke.HW
    x8 = torch.from_numpy(rng.integers(0, 256, (b, hw, hw, 3),
                                       dtype=np.uint8)).cuda()
    z8 = torch.randn(b, cfg.gen.style_dim).cuda()
    x_a, x_b = (torch.from_numpy(rng.uniform(-1, 1, (b, hw, hw, 3))
                                 .astype(np.float32)).cuda()
                for _ in range(2))
    return x8, z8, x_a, x_b


def _train_profile(raw: dict, label: str, x_a, x_b) -> dict:
    trainer = CouncilTrainer(Config.from_dict(raw), device="cuda")
    holder = {"state": trainer.init_state(seed=0)}

    def step():
        holder["state"], _ = trainer.train_step(holder["state"], x_a, x_b)

    return profile(step, 3, 3, label)


def profile_engines() -> list:
    """The serving call and the train step under each conv-engine setting
    of chip_smoke's engines phase, from the same weights."""
    cfg = Config.from_dict(chip_smoke.FLAGSHIP)
    sd = Translator(cfg, device="cuda").init_members(1, seed=0)[0].state_dict()
    x8, z8, x_a, x_b = _inputs(cfg)
    out = []
    for name, over in chip_smoke.ENGINE_SERVE:
        tr = Translator(Config.from_dict({**chip_smoke.FLAGSHIP, **over}),
                        device="cuda")
        gen = tr.load_members([sd])[0]
        out.append(profile(lambda: tr.translate_u8io_device(gen, x8, z=z8),
                           3, 5, f"serve_bucket8_{name}"))
    for name, over in chip_smoke.ENGINE_TRAIN:
        out.append(_train_profile({**chip_smoke.HEADLINE, **over},
                                  f"train_step_{name}", x_a, x_b))
        torch.cuda.empty_cache()
    return out


def replay_host_ms(call, reps: int = 3) -> dict:
    """Host ms of one replay of a captured call: launched on an idle
    device, while the previous replay still runs, and behind a sleep
    kernel of ~0.5 s (a launch that waits for the card's queue to drain
    takes that much longer there; host work that launches the graph
    does not); with the host CPU ms of the idle launch."""
    idle, cpu, busy, behind = [], [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        c0, t0 = time.process_time(), time.perf_counter()
        call.replay()
        idle.append(1e3 * (time.perf_counter() - t0))
        cpu.append(1e3 * (time.process_time() - c0))
        t0 = time.perf_counter()
        call.replay()
        busy.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        torch.cuda._sleep(int(1e9))          # ~0.5 s at <= 2 GHz
        t0 = time.perf_counter()
        call.replay()
        behind.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return {"idle_ms": float(np.median(idle)),
            "idle_cpu_ms": float(np.median(cpu)),
            "in_flight_ms": float(np.median(busy)),
            "behind_sleep_ms": float(np.median(behind))}


def profile_graphs() -> list:
    """Serving at bucket 8 and the headline train step, each eager and
    captured, from the same weights and inputs."""
    cfg = Config.from_dict(chip_smoke.FLAGSHIP)
    tr = Translator(cfg, device="cuda")
    gen = tr.init_members(1, seed=0)[0]
    x8, z8, x_a, x_b = _inputs(cfg)
    hw = (chip_smoke.HW, chip_smoke.HW)
    call = tr.captured("translate_u8io_device", gen, chip_smoke.BATCH, hw)
    out = [profile(lambda: tr.translate_u8io_device(gen, x8, z=z8), 3, 5,
                   "serve_bucket8_eager"),
           profile(lambda: call(x8, z8).clone(), 3, 5,
                   "serve_bucket8_graph")]
    out[-1]["replay_host"] = replay_host_ms(call)
    print(f"[profile] serve_bucket8_graph: replay host ms "
          f"{out[-1]['replay_host']}", flush=True)
    del call, gen, tr
    torch.cuda.empty_cache()
    out.append(_train_profile(chip_smoke.HEADLINE, "train_step_eager", x_a,
                              x_b))
    torch.cuda.empty_cache()
    trainer = CouncilTrainer(Config.from_dict(chip_smoke.HEADLINE),
                             device="cuda")
    holder = {"state": trainer.init_state(seed=0)}
    compiled = trainer.compile_step(holder["state"])

    def step():
        holder["state"], _ = compiled(holder["state"], x_a, x_b)

    out.append(profile(step, 3, 3, "train_step_graph"))
    (call, _), = compiled.calls.values()
    out[-1]["replay_host"] = replay_host_ms(call)
    print(f"[profile] train_step_graph: replay host ms "
          f"{out[-1]['replay_host']}", flush=True)
    return out


def profile_paths() -> list:
    """Serving (plain and W8A8) and the train step, as the module
    docstring lists them."""
    cfg = Config.from_dict(chip_smoke.FLAGSHIP)
    tr = Translator(cfg, device="cuda")
    gen = tr.init_members(1, seed=0)[0]
    x8, z8, x_a, x_b = _inputs(cfg)
    serve = [profile(lambda: tr.translate_u8io_device(gen, x8, z=z8), 3, 5,
                     "serve_bucket8")]
    sd = gen.state_dict()
    del gen, tr
    serve += [profile_quant(mode, scope, sd, x8, z8)
              for scope in ("resblocks", "heavy")
              for mode in ("w8a8", "w8a8_static")]
    return serve + [_train_profile(chip_smoke.HEADLINE, "train_step", x_a,
                                   x_b)]


if __name__ == "__main__":
    main()
