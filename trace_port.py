#!/usr/bin/env python3
"""Read the port's own spans, counters and device marks in a cell of the
benchmark, on one card.

    python3 trace_port.py --workload <cell> --seed <n> --seconds 20 \
        [--trace 0|1] [--record 0|1] [--out FILE]

Runs the cell as ``portbench/run.py`` does (the same set-up, window,
reference check and result line; imports nothing of JAX or ``councilx``),
with the program's recorder (``councilx_torch/utils/trace.py``) on from the
process's start when ``--record 1``. The last line of standard output is
one JSON object: the benchmark's ``line`` and, from the records, ``spans``:

* ``setup_s``: the summed self time of ``setup.kernel_load``,
  ``setup.warmup`` and ``setup.capture`` before the window, and the
  recorder's counters;
* serving: the requests at or above the p95 of their engine time (submit
  to resolved): the mean of each of their five stages and of their engine
  time; the engine's p95 beside the client's (``serve_p95_ms``'s reader:
  arrival time to the answer's callback); the window's stage means;
* training: the median host ms of ``step.prepare``, ``step.replay`` and
  ``step.finish`` over the window's calls, and with ``--trace 1`` the
  device ms of each phase (``CompiledStep.phase_ms``) over 5 calls after
  the window, each followed by a synchronize, beside an event pair around
  each call;
* with ``--trace 1``: the clock anchors (``trace.clock_anchor``) taken
  as the benchmark's call timer opens and closes its window, their errors
  and the device clock's drift against the host's; and the card's idle
  time between the timed calls (the breakdown's first ``idle_gaps`` row)
  split by the innermost span on the thread that launches the calls
  ("idle while <span>", "idle outside any span"), the gaps placed on the
  host clock linearly between the two anchors.

``--out FILE`` writes the object to FILE too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import weakref  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from councilx_torch.inference.server import STAGES  # noqa: E402

SETUP = ("setup.kernel_load", "setup.warmup", "setup.capture")
PHASES = ("translate", "cdis", "dis", "gen")
PHASE_CALLS = 5
# the thread that launches the timed calls, by cell kind
LAUNCHER = {"serve": "councilx-serve-d", "train": "MainThread"}


# -- the records' arithmetic (no device) -------------------------------------

def spans_of(records) -> List[tuple]:
    """The spans among the records, without their extras (a request
    record is no span: its extra holds its stamps)."""
    return [r[:5] for r in records if r[0] != "engine.request"]


def self_ns(spans) -> Dict[int, int]:
    """Each span's self time (its length less its direct children's on the
    same thread), by its index in ``spans``."""
    out = {}
    by_thread: Dict[int, List[int]] = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s[1], []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (spans[i][2], -spans[i][3]))
        stack: List[int] = []
        for i in idx:
            _, _, t0, t1, _ = spans[i]
            while stack and spans[stack[-1]][3] <= t0:
                stack.pop()
            out[i] = t1 - t0
            if stack:
                out[stack[-1]] -= t1 - t0
            stack.append(i)
    return out


def setup_self_s(records, before_ns: Optional[int]) -> Dict[str, float]:
    """Summed self seconds of each set-up span that ended before
    ``before_ns`` (all of them where None)."""
    spans = spans_of(records)
    own = self_ns(spans)
    out = dict.fromkeys(SETUP, 0.0)
    for i, s in enumerate(spans):
        if s[0] in out and (before_ns is None or s[3] <= before_ns):
            out[s[0]] += own[i] / 1e9
    return out


def segments(spans: Sequence[Tuple[int, int, str]]
             ) -> List[Tuple[float, float, Optional[str]]]:
    """The line cut into pieces, each given to the innermost of the nested
    ``(t0, t1, name)`` spans covering it (the last started), or None where
    none does."""
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Tuple[int, int, str]] = []
    cursor = -np.inf

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= s[0]:
            top = stack.pop()
            emit(cursor, top[1], top[2])
            cursor = max(cursor, top[1])
        emit(cursor, s[0], stack[-1][2] if stack else None)
        cursor = max(cursor, s[0])
        stack.append(s)
    while stack:
        top = stack.pop()
        emit(cursor, top[1], top[2])
        cursor = max(cursor, top[1])
    emit(cursor, np.inf, None)
    return out


def idle_by_span(gaps: Sequence[Tuple[float, float]],
                 spans: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Each gap's length split by the innermost span over it: ``{"idle
    while <name>": total, ..., "idle outside any span": total}``, which sum
    to the gaps' total."""
    out: Dict[str, float] = {}
    pieces = segments(spans)
    j = 0
    for g0, g1 in sorted(gaps):
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                key = (f"idle while {name}" if name
                       else "idle outside any span")
                out[key] = out.get(key, 0.0) + part
            k += 1
    return out


def stages(req) -> np.ndarray:
    """A request record's five stages, ns."""
    _, _, t0, t1, _, stamps = req
    return np.diff(np.array((t0, *stamps, t1), dtype=np.int64))


def tail_stages(reqs, q: float = 95.0) -> dict:
    """Over the requests whose engine time is at or above its ``q``-th
    percentile: the mean ms of each stage and of the engine time."""
    eng = np.array([r[3] - r[2] for r in reqs], dtype=np.float64)
    cut = np.percentile(eng, q)
    tail = [r for r, e in zip(reqs, eng) if e >= cut]
    st = np.mean([stages(r) for r in tail], axis=0) / 1e6
    return {"requests": len(tail), "engine_p_ms": float(cut) / 1e6,
            "engine_ms": float(np.mean([r[3] - r[2] for r in tail])) / 1e6,
            "stage_ms": dict(zip(STAGES, st.tolist()))}


def median_ms(spans, name: str, t0: float = -np.inf,
              t1: float = np.inf) -> Optional[float]:
    d = [(s[3] - s[2]) / 1e6 for s in spans
         if s[0] == name and t0 <= s[2] and s[3] <= t1]
    return statistics.median(d) if d else None


# -- on the card --------------------------------------------------------------

def anchored_timer():
    """``portbench.device.CallTimer`` with a clock anchor taken as its
    window opens and as it closes."""
    from councilx_torch.utils import trace
    from portbench.device import CallTimer

    class AnchoredTimer(CallTimer):
        def open(self):
            self.anchors = [trace.clock_anchor()]
            super().open()

        def close(self):
            super().close()
            self.anchors.append(trace.clock_anchor())

    return AnchoredTimer


def clock(timer) -> dict:
    """The anchors' errors, the device clock's drift against the host's,
    and the window's start event on the host clock (ns)."""
    a, b = timer.anchors
    dev_ns = a.event.elapsed_time(b.event) * 1e6
    scale = (b.host_ns - a.host_ns) / dev_ns

    def to_ns(event) -> float:
        return a.host_ns + a.event.elapsed_time(event) * 1e6 * scale

    return {"open_error_ms": a.error_ns / 1e6,
            "close_error_ms": b.error_ns / 1e6,
            "drift_ppm": (scale - 1) * 1e6, "scale": scale,
            "w0_ns": to_ns(timer.window[0]), "to_ns": to_ns,
            "open_ns": a.host_ns, "close_ns": b.host_ns}


def idle_rows(timer_read: dict, clk: dict, spans, launcher: int) -> dict:
    """The idle gaps between the timed calls, split by span on the
    launching thread (host ns), beside their device total (s)."""
    iv = timer_read["intervals"]
    between = [(a[1], b[0]) for a, b in zip(iv, iv[1:])]
    to_ns = lambda s: clk["w0_ns"] + s * 1e9 * clk["scale"]  # noqa: E731
    gaps = [(to_ns(a), to_ns(b)) for a, b in between]
    mine = [(s[2], s[3], s[0]) for s in spans if s[1] == launcher]
    rows = {k: v / 1e9 for k, v in idle_by_span(gaps, mine).items()}
    return {"between_timed_calls_s": sum(b - a for a, b in between),
            "rows_s": dict(sorted(rows.items(), key=lambda kv: -kv[1])),
            "rows_sum_s": sum(rows.values())}


def d2h_split(records, to_ns, t0: float, t1: float) -> dict:
    """The readback's ``engine.d2h`` calls in [t0, t1], split at their
    batch's event placed on the host clock: the median ms waited for the
    device, and the median ms from the device's end to the copy's return
    (the host's wake-up and the copy)."""
    wait, after = [], []
    for r in records:
        if r[0] == "engine.d2h" and r[5] is not None and t0 <= r[2] \
                and r[3] <= t1:
            done = to_ns(r[5])
            wait.append(max(0.0, done - r[2]) / 1e6)
            after.append((r[3] - max(r[2], done)) / 1e6)
    if not wait:
        return {}
    return {"calls": len(wait), "device_wait_ms": statistics.median(wait),
            "after_device_ms": statistics.median(after)}


def read_phases(fn, step_ref, calls: int = PHASE_CALLS) -> dict:
    """``calls`` calls of ``fn`` (one compiled step call each), each
    followed by a synchronize: the step's phase ms and an event pair's ms
    around the call."""
    rows = []
    for _ in range(calls):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        step = step_ref()
        rows.append((step.phase_ms() if step is not None else {},
                     a.elapsed_time(b)))
    out = {"pair_ms": statistics.median(p for _, p in rows)}
    if rows[0][0]:
        med = {k: statistics.median(ph[k] for ph, _ in rows) for k in PHASES}
        out["phase_ms"] = med
        out["sum_over_pair"] = [sum(ph.values()) / p for ph, p in rows]
    return out


def measure(env, bench: dict, workload: str, limits: dict,
            record: bool) -> dict:
    """Drive the cell on ``env`` as ``portbench/run.py`` does (the recorder
    switched on by the caller where ``record``) and read the records."""
    from councilx_torch.utils import trace
    from portbench import harness
    from portbench.device import card
    from portbench.drivers import serve_open, train_step

    kind = "serve" if env.traffic["driver"] == "serve_open" else "train"
    timers: List = []
    held = {}
    patched = []
    if env.trace:
        timer_cls = anchored_timer()
        if kind == "serve":
            class AnchoredTranslator(serve_open.TimedTranslator):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    self.timer = timer_cls()
                    timers.append(self.timer)

            env.hooks["translator"] = AnchoredTranslator
        else:
            class Timer(timer_cls):
                def __init__(self):
                    super().__init__()
                    timers.append(self)

            def wrap(step):
                held["step"] = weakref.ref(step)
                return step

            def profiled(fn, calls):
                held["phases"] = read_phases(fn, held["step"])
                return profile(fn, calls)

            profile = train_step.profile_kernels
            env.hooks["wrap_step"] = wrap
            patched = [(train_step, "CallTimer", train_step.CallTimer),
                       (train_step, "profile_kernels", profile)]
            train_step.CallTimer = Timer
            train_step.profile_kernels = profiled
    try:
        out = harness.drive(env)
    finally:
        for mod, name, value in patched:
            setattr(mod, name, value)
    line = harness.result_line(bench, workload, env.trace, out, limits)

    records = trace.records()
    spans = spans_of(records)
    names = trace.thread_names()
    result = {"workload": workload, "seed": env.seed,
              "trace": int(env.trace), "record": int(record),
              "card": card() if env.device == "cuda" else "cpu",
              "torch": torch.__version__, "line": line}
    fig = {"records": len(records), "dropped": trace.dropped(),
           "counts": trace.counts()}
    clk = None
    if timers and len(getattr(timers[-1], "anchors", ())) == 2:
        clk = clock(timers[-1])
        fig["clock"] = {k: clk[k] for k in ("open_error_ms",
                                            "close_error_ms", "drift_ppm")}
        launcher = [i for i, n in names.items() if n == LAUNCHER[kind]]
        if launcher and out.get("timer"):
            fig["idle"] = idle_rows(out["timer"], clk, spans, launcher[0])
    opened = clk["open_ns"] if clk else -np.inf
    closed = clk["close_ns"] if clk else np.inf
    if record:
        fig["setup_self_s"] = setup_self_s(
            records, None if clk is None else clk["open_ns"])
    if kind == "serve" and record:
        reqs = [r for r in records if r[0] == "engine.request"
                and opened <= r[2] and r[3] <= closed]
        if reqs:
            tail = tail_stages(reqs)
            tail["stages_over_engine"] = (sum(tail["stage_ms"].values())
                                          / tail["engine_ms"])
            fig["tail"] = tail
            eng = [(r[3] - r[2]) / 1e6 for r in reqs]
            fig["engine_p95_ms"] = float(np.percentile(eng, 95))
            fig["client_p95_ms"] = harness.reader("serve_p95_ms")(
                out["readings"])
            fig["mean_stage_ms"] = dict(zip(
                STAGES, (np.mean([stages(r) for r in reqs], axis=0)
                         / 1e6).tolist()))
            fig["span_median_ms"] = {
                n: median_ms(spans, n, opened, closed)
                for n in sorted({s[0] for s in spans
                                 if s[0].startswith("engine.")})}
            if clk:
                fig["d2h_split"] = d2h_split(records, clk["to_ns"], opened,
                                             closed)
    if kind == "train" and record:
        fig["span_median_ms"] = {
            n: median_ms(spans, n, opened, closed)
            for n in ("step.prepare", "step.replay", "step.finish")}
        fig["enqueue_ms_median"] = statistics.median(
            out["readings"]["enqueue_ms"])
        if "phases" in held:
            fig["phases"] = held["phases"]
            if out.get("timer") and out["readings"].get("steps"):
                fig["device_ms_per_step"] = 1e3 * sum(
                    b - a for a, b in out["timer"]["intervals"]) \
                    / out["readings"]["steps"]
    result["spans"] = fig
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from councilx_torch.utils import trace
    if args.record:
        trace.on()

    from portbench import harness

    bench = harness.manifest()
    cell = harness.cell_of(bench, args.workload)
    config = harness.load_json(harness.HERE, "configs",
                               f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                f"{cell['traffic']}.json")
    limits = harness.load_json(harness.HERE, "limits",
                               f"{args.workload}.json")
    env = harness.Env(config=config, traffic=traffic, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=T_START)
    text = json.dumps(measure(env, bench, args.workload, limits,
                              bool(args.record)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
