"""Serving traffic: requests offered to the program's batching engine at a
fixed rate, open loop.

Parameters (a traffic file): ``rate_per_s``, the offered rate; arrivals
come at gaps that are a fixed set of ``gaps`` exponential quantiles (mean
``1 / rate_per_s``), in a new order drawn from the seed each time the set
is used up, so every seed offers the same gaps in another order and the
same number of requests in a window; ``pool``, the number of seeded images
(uint8, the configuration's crop size) and style codes that requests draw
from, in an order drawn from the seed; ``member``, a member index or
``"all"`` (every member's translation under the request's one style
code); the engine's ``max_batch`` and ``max_delay_ms``; ``sample``, how
many answers of the window the reference checks.

The engine is built as ``councilx_torch.cli.serve.build_engine`` builds it
(its defaults: pipeline on, uint8 on the wire) on a :class:`TimedTranslator`,
and warmed up on every bucket of its ladder, since arrivals at random come
in bursts of any size. One sender thread sends each request at its
arrival time; a request is timed from that arrival time (not from when the
sender got to it) to the moment its answer reaches the client, a callback
on the answer's future. Arrivals stop at the window's end; the answers
still due are waited for, and the window ends with the last of them.
"""

from __future__ import annotations

import gc
import math
import random
import threading
import time

import numpy as np
import torch

from councilx_torch.config import Config
from councilx_torch.inference.server import BatchingEngine
from councilx_torch.inference.translate import Translator
from portbench import check
from portbench.device import CallTimer, conv3x3_bound_s, profile_kernels
from portbench.flops import serve_flops
from portbench.reference.step import build, serve_u8
from portbench.weights import make_state

# the program's conv3x3 kernel (K1) in the trace: the 16 resblock convs of
# each member forward run on it and on nothing else at the default engines
CONV3X3_KERNEL = "conv3x3_bf16_kernel"
# how long the answers still due at the window's end are waited for
DRAIN_S = 60.0


class TimedCall:
    """A captured bucket call with the translator's timer around it."""

    def __init__(self, call, timer: CallTimer):
        self.call, self.timer = call, timer

    def __call__(self, *inputs):
        ev = self.timer.start()
        out = self.call(*inputs)
        self.timer.stop(ev)
        return out


class TimedTranslator(Translator):
    """The program's translator; each captured call it hands out records a
    pair of CUDA events around itself while ``timer.on``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.timer = CallTimer()
        self._timed = {}

    def captured(self, method, params, batch, hw):
        call = super().captured(method, params, batch, hw)
        timed = self._timed.get(id(call))
        if timed is None or timed.call is not call:
            timed = self._timed[id(call)] = TimedCall(call, self.timer)
        return timed


def arrivals(rate: float, seconds: float, gaps: int, seed: int) -> np.ndarray:
    """Arrival times in [0, seconds): the ``gaps`` quantiles of an
    exponential of mean ``1 / rate`` at (i + 1/2) / gaps, summed in an
    order drawn from the seed, a new order each time the set is used up."""
    q = -np.log1p(-(np.arange(gaps) + 0.5) / gaps) / rate
    rng = np.random.Generator(np.random.Philox(seed))
    cycles = math.ceil(seconds * rate / gaps) + 1
    times = np.cumsum(np.concatenate([rng.permutation(q)
                                      for _ in range(cycles)]))
    return times[times < seconds]


class OpenLoop:
    """One sender thread submits each request at its arrival time; answers
    come back on the engine's threads. A reservoir sample of the answers,
    drawn from the seed, is kept for the reference."""

    def __init__(self, engine, images, codes, order, times: np.ndarray,
                 sample: int, seed: int):
        self.engine, self.images, self.codes = engine, images, codes
        self.order, self.times = order, times
        self.lock = threading.Condition()
        self.sent = 0
        self.answered = 0
        self.latency_s = []
        self.failed = 0
        self.rng = random.Random(seed)
        self.sample, self.kept = sample, []
        self.sender = threading.Thread(target=self._send_loop, daemon=True,
                                       name="portbench-arrivals")

    def start(self, t0: float):
        self.t0 = t0
        self.sender.start()

    def _send_loop(self):
        for k, at in enumerate(self.times):
            due = self.t0 + float(at)
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            idx = int(self.order[k % len(self.order)])
            with self.lock:
                self.sent += 1
            fut = self.engine.submit(self.images[idx], z=self.codes[idx])
            fut.add_done_callback(lambda f, idx=idx, due=due:
                                  self._answer(f, idx, due))

    def _answer(self, fut, idx: int, due: float):
        now = time.perf_counter()
        with self.lock:
            self.latency_s.append(now - due)
            if fut.exception() is not None:
                self.failed += 1
            else:
                self.answered += 1
                if len(self.kept) < self.sample:
                    self.kept.append((idx, np.array(fut.result())))
                else:
                    j = self.rng.randrange(self.answered)
                    if j < self.sample:
                        self.kept[j] = (idx, np.array(fut.result()))
            self.lock.notify_all()

    def close(self, timeout: float = DRAIN_S) -> bool:
        """Wait for the last arrival to be sent and every request sent to
        have its answer."""
        self.sender.join()
        with self.lock:
            return self.lock.wait_for(
                lambda: len(self.latency_s) == self.sent, timeout)


def stats_delta(a: dict, b: dict) -> dict:
    """The engine's counters over the window, from two snapshots."""
    hist = {k: v - a["batch_size_histogram"].get(k, 0)
            for k, v in b["batch_size_histogram"].items()}
    return {"batches": b["batches"] - a["batches"],
            "padded_rows": b["padded_rows"] - a["padded_rows"],
            "images_done": b["images_done"] - a["images_done"],
            "rows": sum(k * v for k, v in hist.items()),
            "histogram": {k: v for k, v in hist.items() if v}}


def serving(env) -> dict:
    """Set-up: the weights, the request pool and the engine, every bucket
    warmed up."""
    cfg, dev, traffic = env.config["config"], torch.device(env.device), \
        env.traffic
    hw, pool = cfg["crop_image_height"], traffic["pool"]
    all_members = traffic["member"] == "all"
    gen = torch.Generator(device=dev)
    gen.manual_seed(env.seed)
    p0 = make_state(cfg, gen, dev, groups=("gen",))["gen"]
    members = p0 if all_members else [p0[int(traffic["member"])]]
    images = torch.randint(0, 256, (pool, hw, hw, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    codes = torch.randn((pool, cfg["gen"]["style_dim"]), generator=gen,
                        device=dev)
    order = torch.randperm(pool, generator=gen, device=dev)

    cls = env.hooks.get("translator", TimedTranslator)
    translator = cls(Config.from_dict(cfg), device=dev)
    params = translator.load_members(members)
    engine = BatchingEngine(
        translator, params if all_members else params[0],
        image_hw=(hw, hw), max_batch=traffic["max_batch"],
        max_delay_ms=traffic["max_delay_ms"], all_members=all_members)
    engine.start()
    engine.warmup()
    return {"engine": engine, "translator": translator, "members": members,
            "images": images, "codes": codes,
            "images_np": images.cpu().numpy(),
            "codes_np": codes.cpu().numpy(), "order": order.cpu().numpy(),
            "all_members": all_members, "hw": hw}


def offer(s: dict, rate: float, seconds: float, traffic: dict,
          seed: int) -> OpenLoop:
    """Offer ``rate`` requests a second for ``seconds`` to the engine and
    wait for their answers."""
    loop = OpenLoop(s["engine"], s["images_np"], s["codes_np"], s["order"],
                    arrivals(rate, seconds, traffic["gaps"], seed),
                    traffic["sample"], seed)
    loop.start(time.perf_counter())
    loop.close()
    return loop


def run(env) -> dict:
    cfg, dev, traffic = env.config["config"], torch.device(env.device), \
        env.traffic
    s = serving(env)
    engine, translator, hw = s["engine"], s["translator"], s["hw"]
    n = cfg["council"]["council_size"]

    timer = translator.timer
    traced = env.trace and dev.type == "cuda"
    before = engine.snapshot_stats()
    env.sync()
    t0 = time.perf_counter()
    setup_s = t0 - env.t_start
    if traced:
        timer.open()
    loop = offer(s, traffic["rate_per_s"], env.seconds, traffic, env.seed)
    if traced:
        timer.close()
    env.sync()
    window_s = time.perf_counter() - t0
    delta = stats_delta(before, engine.snapshot_stats())

    out = {"readings": {"kind": "serve", "setup_s": setup_s,
                        "window_s": window_s, "requests": loop.sent,
                        "latency_s": list(loop.latency_s), "stats": delta},
           "attempted": loop.sent,
           "failed": loop.failed + (loop.sent - len(loop.latency_s)),
           "memory_peak_bytes": env.memory_peak()}
    if traced:
        out["timer"] = timer.read()
        out["readings"]["flops_per_request"] = serve_flops(cfg, hw) * (
            n if s["all_members"] else 1)
    if traced and delta["histogram"]:
        bucket = max(delta["histogram"], key=delta["histogram"].get)
        call = engine.captured(bucket).call
        x = torch.from_numpy(np.zeros((bucket, hw, hw, 3), np.uint8))
        zz = torch.zeros((bucket, cfg["gen"]["style_dim"]))
        reps = 5
        kernels = profile_kernels(lambda: call(x, zz), calls=reps)
        out["kernels"] = kernels
        conv_s = sum(t for k, t in (kernels or {}).items()
                     if CONV3X3_KERNEL in k)
        if conv_s > 0:
            convs = 16 * (n if s["all_members"] else 1) * reps
            bound = convs * conv3x3_bound_s((bucket, hw // 4, hw // 4,
                                             256, 256))
            out["readings"]["conv3x3"] = {"bound_s": bound,
                                          "device_s": conv_s}
    engine.stop()
    kept, members, all_members = loop.kept, s["members"], s["all_members"]
    images, codes = s["images"], s["codes"]
    del engine, translator, loop, s
    gc.collect()
    env.free()

    ref = []
    for sd in members:
        m = build(cfg, "gen", device=dev)
        m.load_state_dict(sd, strict=True)
        ref.append(m)
    readings = []
    chunk = 16
    for lo in range(0, len(kept), chunk):
        part = kept[lo:lo + chunk]
        idx = torch.tensor([i for i, _ in part], device=dev)
        want = serve_u8(ref, images[idx], codes[idx])      # (N, b, H, W, 3)
        for j, (_, got) in enumerate(part):
            got = torch.from_numpy(np.asarray(got)).to(dev)
            readings.append(check.answer_gaps(
                got, want[:, j] if all_members else want[0, j]))
    out["checks"] = check.worst(readings)
    return out
