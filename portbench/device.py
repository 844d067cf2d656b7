"""The card: its name and power limit, its peak, and device time by events.

Frozen copies from the repository's chip tooling (``chip_smoke.py``:
``PEAK_OPS``, ``PEAK_BYTES``, the conv rows of ``kernel_work`` and
``bound_ms``, ``card``, and ``route_profile``'s retried trace), so that a
later change to that tooling cannot move the yardstick.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W: bf16 on the tensor
# cores, f32 on the FMA units; device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def conv3x3_work(shape, esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one 3x3 stride-1 conv call: ``shape`` (B, H,
    W, C, O) of the output grid, the padded input (B, H+2, W+2, C) and the
    kernel read once, the output written once."""
    b, h, w, c, o = shape
    ops = 2 * b * h * w * 9 * c * o
    elems = b * (h + 2) * (w + 2) * c + b * h * w * o + 9 * c * o
    return ops, esize * elems


def conv3x3_bound_s(shape, esize: int = 2) -> float:
    """The least time the card could take for one such call: the larger of
    its operations over the bf16 peak and its bytes over the memory rate."""
    ops, nbytes = conv3x3_work(shape, esize)
    return max(ops / PEAK_OPS["bf16"], nbytes / PEAK_BYTES)


def card() -> str:
    """``name, power limit`` of the first card, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class CallTimer:
    """CUDA events on the calling stream: a pair around the window, and a
    pair around each call made in it. Calls on one stream run one after
    another and within the window's pair, so the calls' summed device time
    is time in which the card worked on them, and never more than the
    window's device time: both are read on the card's clock."""

    def __init__(self):
        self.pairs: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.window: List[torch.cuda.Event] = []
        self.on = False

    @staticmethod
    def _record() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open(self) -> None:
        """Start the window (on a drained card) and time calls from now."""
        self.window = [self._record()]
        self.on = True

    def close(self) -> None:
        self.on = False
        self.window.append(self._record())

    def start(self) -> Optional[torch.cuda.Event]:
        return self._record() if self.on else None

    def stop(self, start: Optional[torch.cuda.Event]) -> None:
        if start is not None:
            self.pairs.append((start, self._record()))

    def read(self) -> dict:
        """After a synchronize: the window's device seconds, and each
        call's (start, end) in seconds from the window's start."""
        w0, w1 = self.window
        return {"window_s": w0.elapsed_time(w1) / 1e3,
                "intervals": [(w0.elapsed_time(a) / 1e3,
                               w0.elapsed_time(b) / 1e3)
                              for a, b in self.pairs]}


def profile_kernels(fn, calls: int, attempts: int = 3) -> Optional[dict]:
    """``{kernel name: device seconds}`` over ``calls`` calls of ``fn``
    from a ``torch.profiler`` trace; the trace is taken again when it holds
    no device event, at most ``attempts`` times. None if none held one."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = e.time_range.end - e.time_range.start
                out[e.name] = out.get(e.name, 0.0) + us / 1e6
        if out:
            return out
    return None
