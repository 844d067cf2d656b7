"""The benchmark's harness: it finds a cell's files by name, drives the cell,
assembles the metrics its role declares, checks its own last line and
prints it.

Everything belonging to one configuration, traffic mix or metric is a file
of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration (its ``config`` dict is what
  the program and the reference are built from);
* ``traffic/<traffic>.json``: the parameters of one traffic mix; its
  ``driver`` names the general generator under ``drivers/`` that reads it;
* ``metrics/<metric>.py``: one reader per metric, ``read(readings)`` ->
  a number, or None where the run holds nothing for it to read;
* ``limits/<cell>.json``: the limit of each number that decides the cell's
  ``correct``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that nothing the benchmark runs may load: JAX and the
# JAX package the program was ported from (compared as whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "councilx")


def load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def declared(bench: dict, cell: str, role: str) -> Dict[str, dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (``role="e2e"``, an untraced run) or its per-layer metrics
    (``"layer"``, a traced run), by name."""
    group = bench["end_to_end" if role == "e2e" else "per_layer"]
    return {m["name"]: m for m in group
            if "workloads" not in m or cell in m["workloads"]}


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def assemble(bench: dict, cell: str, role: str,
             readings: dict) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric the role declares that
    its reader finds in ``readings``."""
    out = {}
    for name, m in declared(bench, cell, role).items():
        value = reader(name)(readings)
        if value is not None:
            out[name] = {"value": float(value), "unit": m["unit"]}
    return out


def line_faults(bench: dict, cell: str, role: str, line: dict) -> list:
    """What is wrong with a result line, as names: each declared metric
    missing, not finite or with another unit; in a traced run, the device's
    window and busy time unless 0 < busy_s <= window_s."""
    faults = []
    metrics = line.get("metrics", {})
    for name, m in declared(bench, cell, role).items():
        got = metrics.get(name)
        if got is None:
            faults.append(f"metric {name} missing")
        elif not math.isfinite(got["value"]) or got["unit"] != m["unit"]:
            faults.append(f"metric {name} reads {got}")
    if role == "layer":
        dev = line.get("device", {})
        busy, window = dev.get("busy_s"), dev.get("window_s")
        if busy is None or window is None or not 0 < busy <= window:
            faults.append(f"device busy_s {busy} / window_s {window}")
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        if key not in line:
            faults.append(f"key {key} missing")
    return faults


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Env:
    """What a driver gets: the cell's configuration and traffic, the run's
    seed, window and role, the device, and hooks that a test sets to break
    the timed path underneath."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    hooks: Dict[str, Any] = field(default_factory=dict)

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if torch.device(self.device).type == "cuda":
            return int(torch.cuda.max_memory_allocated())
        return 0

    def free(self) -> None:
        """After the window: drop the program's memory, and run the
        reference in float32 with TF32 off."""
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def drive(env: Env) -> dict:
    """Run the traffic's driver on ``env``."""
    module = importlib.import_module(
        f"portbench.drivers.{env.traffic['driver']}")
    return module.run(env)


def judge(out: dict, limits: Dict[str, float]) -> bool:
    """Correct: every number within its limit, something attempted and
    nothing failed."""
    checks = out["checks"]
    ok = all(math.isfinite(checks.get(k, math.nan)) and checks[k] <= lim
             for k, lim in limits.items())
    return ok and out["attempted"] > 0 and out["failed"] == 0


def breakdown(out: dict) -> Optional[dict]:
    """The ten device operations that took most time in the profiled calls
    after the window, and the card's idle time in the window by where it
    fell."""
    result = {}
    if out.get("kernels"):
        top = sorted(out["kernels"].items(), key=lambda kv: -kv[1])[:10]
        result["device_ops"] = [[k[:120], v] for k, v in top]
    timer = out.get("timer")
    if timer and timer["intervals"]:
        iv = timer["intervals"]
        between = [b[0] - a[1] for a, b in zip(iv, iv[1:])]
        result["idle_gaps"] = [
            ["between timed calls (host: staging inputs and enqueue; "
             "engine: coalescing and assembly)", sum(between)],
            ["largest single gap between timed calls",
             max(between, default=0.0)],
            ["window start to the first timed call", iv[0][0]],
            ["last timed call to the window's end",
             timer["window_s"] - iv[-1][1]]]
    return result or None


def result_line(bench: dict, cell: str, trace: bool, out: dict,
                limits: Dict[str, float]) -> dict:
    readings = out["readings"]
    role = "layer" if trace else "e2e"
    if out.get("timer"):
        readings["busy_s"] = sum(b - a for a, b in out["timer"]["intervals"])
        readings["device_window_s"] = out["timer"]["window_s"]
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(0)
              if torch.cuda.is_available() else "cpu",
              "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        device["window_s"] = readings.get("device_window_s")
        device["busy_s"] = readings.get("busy_s")
    line = {"correct": judge(out, limits), "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": assemble(bench, cell, role, readings),
            "device": device}
    if trace:
        bd = breakdown(out)
        if bd:
            line["breakdown"] = bd
    line["checks"] = {k: {"value": out["checks"].get(k, math.nan),
                          "limit": lim} for k, lim in limits.items()}
    return line
