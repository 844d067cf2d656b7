"""Spans, counters and device marks recorded inside the port.

Off by default; :func:`on` and :func:`off` switch it in code. Off, a span
site costs one flag check and records nothing. On, each record is a tuple
``(name, thread ident, t0_ns, t1_ns, id, *extra)`` on
``time.perf_counter_ns``, appended without a lock to one bounded list
(:func:`records`; past the bound a record is dropped and counted,
:func:`dropped`), and counters add up by name (:func:`count`,
:func:`counts`).

What records what:

* ``inference/server.py``: one ``engine.request`` per request, its ``id``
  the batch, its extra the four stamps between submit (``t0``) and
  resolved (``t1``): taken off the queue, batch closed, launch returned,
  host copy done, so its five stages are queue, coalesce, dispatch,
  inflight and resolve; per batch, the dispatch thread's
  ``engine.collect``, ``engine.assemble``, ``engine.stage``,
  ``engine.replay`` (``engine.eager`` off the card), ``engine.clone``,
  ``engine.handoff`` and the readback thread's ``engine.d2h`` (the wait
  for the device and the copy, one call; its extra is the batch's timing
  event, None off the card) and ``engine.resolve``.
* ``train/trainer.py`` ``CompiledStep``: ``step.prepare``,
  ``step.replay``, ``step.finish`` per call; and the step's device marks
  (``step.entry``, ``step.translate``, ``step.cdis``, ``step.dis``,
  ``step.gen``), which a capture made while on turns into event nodes
  that fire at every replay (``CompiledStep.phase_ms``).
* set-up: ``setup.kernel_load`` (``ops/_build.py``, with the counters
  ``kernels_built`` and ``kernels_loaded``), ``setup.warmup``
  (``CaptureContext.run``, ending in a synchronize while on) and
  ``setup.capture`` (``CapturedCall``'s timed part).

Spans on one thread nest; a span's self time is its length less its
children's. :func:`clock_anchor` pairs a timing event with the host clock,
so that device events can be placed among the host's spans.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

LIMIT = 1 << 20

_on = False
_limit = LIMIT
_records: List[tuple] = []
_dropped = 0
_counts: Dict[str, int] = {}
_marks: List[Tuple[str, torch.cuda.Event, bool]] = []
_threads: Dict[int, str] = {}


def on(limit: int = LIMIT) -> None:
    """Record from now on, at most ``limit`` records."""
    global _on, _limit
    _limit, _on = limit, True


def off() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Forget every record, counter, mark and drop."""
    global _dropped
    _records.clear()
    _counts.clear()
    _marks.clear()
    _threads.clear()
    _dropped = 0


def records() -> List[tuple]:
    return list(_records)


def dropped() -> int:
    return _dropped


def counts() -> Dict[str, int]:
    return dict(_counts)


def marks() -> List[Tuple[str, torch.cuda.Event, bool]]:
    """``(name, event, captured)`` of every device mark, in order."""
    return list(_marks)


def thread_names() -> Dict[int, str]:
    """The name of each thread that recorded, by ident."""
    return dict(_threads)


def add(name: str, t0_ns: int, t1_ns: int, id: int = 0, *extra) -> None:
    """Record ``(name, this thread, t0_ns, t1_ns, id, *extra)``."""
    global _dropped
    if not _on:
        return
    if len(_records) >= _limit:
        _dropped += 1
        return
    ident = threading.get_ident()
    if ident not in _threads:
        _threads[ident] = threading.current_thread().name
    _records.append((name, ident, t0_ns, t1_ns, id) + extra)


class _Span:
    __slots__ = ("name", "id", "t0")

    def __init__(self, name: str, id: int):
        self.name, self.id = name, id

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        add(self.name, self.t0, time.perf_counter_ns(), self.id)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, id: int = 0):
    """``with span(name):`` records the block's host interval while on."""
    return _Span(name, id) if _on else _OFF


def count(name: str, n: int = 1) -> None:
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def device_mark(name: str, device) -> Optional[torch.cuda.Event]:
    """While on and ``device`` is CUDA: a timing event recorded on the
    current stream, kept under ``name`` (within the records' bound).
    During a stream capture it is an external event, which the graph
    records as a node at every replay."""
    global _dropped
    if not _on or torch.device(device).type != "cuda":
        return None
    if len(_marks) >= _limit:
        _dropped += 1
        return None
    captured = torch.cuda.is_current_stream_capturing()
    ev = torch.cuda.Event(enable_timing=True, external=captured)
    ev.record()
    _marks.append((name, ev, captured))
    return ev


class Anchor(NamedTuple):
    """A timing event and the host clock (ns) read once it had fired;
    ``error_ns`` is how long the host waited for it, so the event fired
    within ``error_ns`` before ``host_ns``."""

    event: torch.cuda.Event
    host_ns: int
    error_ns: int


def clock_anchor(device=None) -> Anchor:
    """Drain ``device``, record a timing event on its current stream, wait
    for it and read the host clock."""
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter_ns()
    ev.record(torch.cuda.current_stream(device))
    ev.synchronize()
    t1 = time.perf_counter_ns()
    return Anchor(ev, t1, t1 - t0)
