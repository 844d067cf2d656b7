"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles its train step once and replays it
(``councilx/train/trainer.py``: ``jax.jit(self._step, donate_argnums=(0,))``)
and builds one executable per serving bucket at startup
(``councilx/inference/server.py``: ``BatchingEngine.warmup``). The port
captures the same eager functions as CUDA graphs and replays them, so one
replay launches the call's few hundred (serving) or tens of thousands
(training) kernels with one host call.

:class:`CaptureContext` owns one side stream and one private memory pool.
The graphs captured in it share the pool, so they must never run at the
same time: a trainer's step graphs, or one translator's buckets, which one
thread replays in turn. Its recipe is PyTorch's:

1. :meth:`CaptureContext.run`: the function eagerly on the side stream, as
   the warm-up. Whatever is built lazily at a first call is built there,
   outside the capture: the kernels' libraries and their shared-memory
   attributes (once per thread, autograd's included), the conv wgrad's
   per-stream ticket counters (``ops/conv3x3.py``, keyed by this stream),
   the derived-weight and int8-weight caches, cuDNN's and cuBLAS's handles,
   and each process group's NCCL communicator (PyTorch makes it at the
   group's first collective; inside a capture a collective is recorded on
   the group's stream, joined to the capture's, like any kernel).
   A tensor first made inside a capture lives in the graph's pool and
   holds no value until a replay, so an eager call after the capture would
   read garbage from such a cache.
2. :meth:`CaptureContext.capture`: static input buffers, then
   ``torch.cuda.graph`` on the same stream into the shared pool, in the
   ``thread_local`` capture mode: other threads (the train loop's
   prefetch worker, which pins memory) may go on with host work while one
   thread captures. Every Python number the function reads is frozen into
   the graph at its capture value; what varies from call to call must be a
   tensor among the inputs (or state the graph updates in place).
3. :meth:`CapturedCall.__call__`: copy the inputs into the static buffers
   on the current stream, then ``replay()``. The outputs are the graph's
   own tensors, overwritten by the next replay.

A CPU device raises, and so does a failed capture, naming the call: there
is no eager fallback.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

from councilx_torch.utils import trace


def capturable(device) -> bool:
    """Whether work on ``device`` is captured: CUDA only."""
    return torch.device(device).type == "cuda"


def require_cuda(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a ValueError unless it is CUDA."""
    device = torch.device(device)
    if not capturable(device):
        raise ValueError(f"{what}: CUDA graphs capture CUDA work, and this "
                         f"runs on {device}; run it eagerly there")
    return device


class CapturedCall:
    """One function captured as one CUDA graph over static inputs;
    ``capture_seconds`` is the host time the capture took (the graph's
    capture and instantiation, after the device drained)."""

    def __init__(self, ctx: "CaptureContext", fn: Callable,
                 inputs: Sequence[torch.Tensor], name: str):
        self.name = name
        for t in inputs:
            if t.device != ctx.device:
                raise ValueError(f"{name}: input on {t.device}, the capture "
                                 f"runs on {ctx.device}")
        # static buffers, made outside the pool, which the caller's values
        # are copied into before each replay
        self.inputs = [torch.empty_like(t) for t in inputs]
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(ctx.device)
        ctx.stream.wait_stream(current)
        torch.cuda.synchronize(ctx.device)
        with trace.span("setup.capture"):
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, pool=ctx.pool,
                                      stream=ctx.stream,
                                      capture_error_mode="thread_local"):
                    self.output = fn(*self.inputs)
            except RuntimeError as e:
                raise RuntimeError(f"CUDA graph capture of {name} failed: "
                                   f"{e}") from e
            current.wait_stream(ctx.stream)
            torch.cuda.synchronize(ctx.device)
            self.capture_seconds = time.perf_counter() - t0
        self.replays = 0

    def copy_inputs(self, inputs: Sequence[torch.Tensor]) -> None:
        """Copy ``inputs`` (device tensors, or host tensors, pinned for an
        asynchronous copy) into the static buffers on the current stream."""
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs for "
                             f"{len(self.inputs)} captured")
        for i, (dst, src) in enumerate(zip(self.inputs, inputs)):
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"{self.name}: input {i} is {tuple(src.shape)} "
                    f"{src.dtype}, captured as {tuple(dst.shape)} "
                    f"{dst.dtype}")
            if src.device.type == "cpu" and not src.is_pinned():
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def replay(self) -> Any:
        """Replay on the current stream -> the graph's output tensors."""
        self.graph.replay()
        self.replays += 1
        return self.output

    def __call__(self, *inputs: torch.Tensor) -> Any:
        self.copy_inputs(inputs)
        return self.replay()


class CaptureContext:
    """A side stream and a private memory pool on one CUDA device, shared by
    the graphs captured in it (graphs that never run at the same time)."""

    def __init__(self, device, what: str = "capture"):
        self.device = require_cuda(device, what)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def run(self, fn: Callable, *args) -> Any:
        """``fn(*args)`` eagerly on the side stream (a warm-up), ordered
        after the current stream's work and before its later work. While
        tracing is on it ends in a synchronize, so that its span holds its
        device time and the next capture none of it."""
        with trace.span("setup.warmup"):
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                out = fn(*args)
            current.wait_stream(self.stream)
            if trace.enabled():
                torch.cuda.synchronize(self.device)
        return out

    def capture(self, fn: Callable, inputs: Sequence[torch.Tensor],
                name: str) -> CapturedCall:
        """``fn`` over static copies of ``inputs``, captured (warm it up with
        :meth:`run` first)."""
        return CapturedCall(self, fn, inputs, name)
