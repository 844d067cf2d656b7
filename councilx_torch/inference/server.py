"""Production serving engine: dynamic micro-batching over the translator.

Counterpart of ``councilx/inference/server.py::BatchingEngine``; the
serving-scale counterpart of the reference's one-image-at-a-time
``test_on_folder.py`` / ``test_gui.py`` paths (SURVEY.md §3.4/§3.5).

* **Batch buckets.** Requests are coalesced and padded up to the next
  bucket of a power-of-two ladder (1, 2, 4, ... max_batch), so the device
  only ever sees a few batch shapes; :meth:`BatchingEngine.warmup` builds
  each at startup so no request pays for it.
* **Captured buckets.** On a card each bucket's device call is captured
  (``Translator.captured``: a CUDA graph; a sharded translator's
  ``captured``: one graph per device, ``ShardedCall``), the counterpart of
  the JAX engine's one executable per bucket: warm-up captures every
  bucket, and a batch is copied into its bucket's static input and
  replayed. A replay overwrites its output while the readback thread may
  still be reading the previous batch's, so each replay's output is
  copied out (one device-to-device copy of the batch's uint8 result,
  ordered after the replay on the dispatch stream; a sharded call's
  gather is that copy) rather than served from a second graph per
  bucket, which would hold a second pool of activations. CPU translators
  run eagerly (``BatchingEngine.graphs``).
* **Deadline-based coalescing.** The worker takes the first queued request,
  then drains the queue until either ``max_batch`` requests are in hand or
  ``max_delay_ms`` has elapsed since the first arrival — the standard
  latency/throughput knob (0 = no added latency, serve singles).
* **uint8 on the wire, both ways.** The default wire format ships uint8
  batches to the device and normalizes there (``translate_u8io_device``,
  the exact host formula), and denormalizes to uint8 on the device before
  the readback — 4x less host<->device traffic than f32.
* **Full-duplex pipeline.** A dispatch thread assembles, uploads and
  launches batch k+1 while a readback thread copies batch k's result to
  the host — upload, device compute and download of consecutive batches
  overlap (bounded 2-deep, so at most two batches are in flight).
  ``pipeline=False`` serializes the cycle on one thread for
  latency-honest single-stream runs.

The z style vector is drawn per request (host-side, from a per-request
``numpy`` Philox stream keyed by the seed) or supplied explicitly —
reproducible per seed.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from councilx_torch.utils import trace
from councilx_torch.utils.graphs import capturable

# a request's stages, between its stamps: submit -> taken off the queue ->
# its batch closed -> the batch's launch returned -> the result on the host
# -> its future resolved
STAGES = ("queue", "coalesce", "dispatch", "inflight", "resolve")


def _set_result(future: Future, value) -> None:
    """Resolve a future, tolerating a concurrent client cancel(): done()
    pre-checks are TOCTOU (cancel can land between the check and the set,
    and an unhandled InvalidStateError would kill the worker thread and
    wedge the engine) — catching the race is the only airtight form."""
    try:
        future.set_result(value)
    except InvalidStateError:
        pass                              # client cancelled; result dropped


def _set_exception(future: Future, exc: Exception) -> None:
    """set_exception with the same cancel-race tolerance as _set_result."""
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


def _bucket_ladder(max_batch: int, multiple: int = 1) -> List[int]:
    """Power-of-two ladder of batch sizes, each a multiple of ``multiple``
    (a data-parallel translator's data size), capped at max_batch (which is
    always included)."""
    ladder = []
    b = multiple
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


@dataclass
class _Request:
    x: np.ndarray            # (H, W, 3) uint8 or float32 in [-1, 1]
    z: np.ndarray            # (style_dim,) float32
    future: Future = field(default_factory=Future)
    # perf_counter_ns stamps: submitted, and taken off the queue
    t_submit: int = field(default_factory=time.perf_counter_ns)
    t_taken: int = 0


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    images_done: int = 0
    batch_hist: dict = field(default_factory=dict)
    # over the resolved requests: their count, and the ns of each stage
    # (``STAGES``) summed; a request's stages sum to its latency
    resolved: int = 0
    stage_ns: dict = field(default_factory=lambda: dict.fromkeys(STAGES, 0))

    def snapshot(self) -> dict:
        n = max(self.resolved, 1)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "images_done": self.images_done,
            "padded_rows": self.padded_rows,
            "mean_latency_ms": round(sum(self.stage_ns.values()) / n / 1e6,
                                     3),
            "mean_stage_ms": {k: round(v / n / 1e6, 3)
                              for k, v in self.stage_ns.items()},
            "batch_size_histogram": dict(sorted(self.batch_hist.items())),
        }


class BatchingEngine:
    """Coalesce concurrent translate requests into padded static-shape
    batches on a single device worker thread.

    Parameters
    ----------
    translator : Translator
        The translate stack (councilx_torch.inference.translate).
    params
        One member's ``AdaINGen``, or the sequence of all members' with
        ``all_members=True``.
    image_hw : (int, int)
        The fixed serving resolution (requests are validated against it;
        static shapes are what make the bucket ladder finite).
    max_batch, max_delay_ms
        Coalescing knobs (see module docstring).
    wire_format : "u8" | "f32"
        "u8" (default): requests are uint8 (H,W,3) in [0,255], normalized
        on device — 4x less host->device traffic. "f32": requests are
        float32 in [-1,1] (the CLI convention).
    all_members : bool
        Council-ensemble mode: ``params`` is the sequence of N members and
        every request resolves to all N members' translations of its image
        under one shared style draw — shape (N, H, W, 3) uint8. The members
        run one after another on each batch, or split over the devices of
        a ``MemberShardedTranslator``.

    A ``ShardedTranslator`` serves one member with the batch split over its
    devices: every bucket is a multiple of its data size, and so must
    ``max_batch`` be.
    """

    def __init__(self, translator, params, image_hw, max_batch: int = 64,
                 max_delay_ms: float = 5.0, pipeline: bool = True,
                 wire_format: str = "u8", all_members: bool = False):
        if wire_format not in ("u8", "f32"):
            raise ValueError(f"wire_format must be 'u8' or 'f32', "
                             f"got {wire_format!r}")
        self.wire_format = wire_format
        self._wire_dtype = np.uint8 if wire_format == "u8" else np.float32
        self.all_members = all_members
        axes = translator.axis_names
        if all_members and axes and "council" not in axes:
            raise ValueError(
                "all_members serving cannot split only the batch: use a "
                "MemberShardedTranslator to shard the members")
        if not all_members and "council" in axes:
            raise ValueError("a member-sharded translator serves all "
                             "members: build the engine with "
                             "all_members=True (or use ShardedTranslator "
                             "for one member over several devices)")
        # the route, by the translator's device: each bucket captured on a
        # card (a sharded translator: one graph per device), eager on the
        # CPU
        self.graphs = capturable(translator.device)
        self.replays = 0        # captured calls replayed (graphs)
        if all_members:
            self._method = ("translate_all_u8io_device" if wire_format == "u8"
                            else "translate_all_u8_device")
        else:
            self._method = ("translate_u8io_device" if wire_format == "u8"
                            else "translate_u8_device")
        self.n_members = len(params) if all_members else 1
        self.translator = translator
        self.style_dim = translator.cfg.gen.style_dim
        self.image_hw = tuple(image_hw)
        multiple = translator.data_size
        if max_batch % multiple:
            raise ValueError(f"max_batch {max_batch} must be a multiple of "
                             f"the serving data size {multiple}")
        self.buckets = _bucket_ladder(max_batch, multiple)
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.params = params
        self._copy_stream = (torch.cuda.Stream(device=translator.device)
                             if translator.device.type == "cuda" else None)
        # full-duplex pipeline: the dispatch thread assembles + uploads +
        # enqueues batch k+1 while the readback thread drains batch k — the
        # H2D copy, device compute and D2H copy of consecutive batches
        # overlap (at most 2 batches in flight, bounded by the queue)
        self.pipeline = pipeline
        self.stats = EngineStats()
        self._stats_lock = threading.Lock()
        # serializes submit()'s running-check+enqueue against stop()'s
        # flag-flip+drain, so no request can slip into the queue after the
        # drain and strand its future
        self._lifecycle_lock = threading.Lock()
        self._graph_lock = threading.Lock()
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._ready: "queue.Queue" = queue.Queue(maxsize=2)
        self._batch_id = 0      # the dispatch thread's batch count
        self._dispatcher: Optional[threading.Thread] = None
        self._reader: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._running:
            return
        self._running = True
        self._dispatcher = threading.Thread(
            target=self._run_dispatch, daemon=True, name="councilx-serve-d")
        self._dispatcher.start()
        if self.pipeline:
            self._reader = threading.Thread(
                target=self._run_readback, daemon=True,
                name="councilx-serve-r")
            self._reader.start()

    def stop(self):
        with self._lifecycle_lock:
            if not self._running:
                return
            self._running = False
        self._q.put(None)                      # wake the dispatcher
        self._dispatcher.join(timeout=60)
        self._dispatcher = None
        if self._reader is not None:
            self._reader.join(timeout=60)      # sentinel sent by dispatcher
            self._reader = None
        # fail any request still in the queue behind the sentinel — its
        # future would otherwise never resolve (the lifecycle lock means
        # nothing can enqueue after _running flipped, so this drain is
        # complete)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                _set_exception(req.future, RuntimeError("engine stopped"))

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            return self.stats.snapshot()

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Build every bucket before taking traffic, so kernel builds, the
        first launches at each shape and the captures never land on a live
        request: with graphs, capture each bucket and replay it once;
        eagerly, run it once."""
        h, w = self.image_hw
        for b in buckets if buckets is not None else self.buckets:
            x = np.zeros((b, h, w, 3), self._wire_dtype)
            z = np.zeros((b, self.style_dim), np.float32)
            self._device_call(x, z).cpu()

    def captured(self, bucket: int):
        """The bucket's captured device call (the translator's
        ``captured``), captured at first use."""
        return self.translator.captured(self._method, self.params, bucket,
                                         self.image_hw)

    # -- request path -------------------------------------------------------

    def make_z(self, seed: int) -> np.ndarray:
        """Per-request style draw: standard normal from a Philox stream
        keyed by the seed — a standard normal like the CLI's draw,
        reproducible, no device dispatch."""
        gen = np.random.Generator(np.random.Philox(seed))
        return gen.standard_normal(self.style_dim).astype(np.float32)

    def submit(self, x: np.ndarray, z: Optional[np.ndarray] = None,
               seed: int = 0) -> Future:
        """Enqueue one image (H,W,3) — uint8 in [0,255] ("u8" wire) or
        float32 in [-1,1] ("f32" wire); resolves to the translated uint8
        (H,W,3) array."""
        if not self._running:
            raise RuntimeError("engine not started")
        h, w = self.image_hw
        x = np.asarray(x)
        if x.shape != (h, w, 3):
            raise ValueError(f"request shape {x.shape} != serving shape "
                             f"{(h, w, 3)} (resize host-side)")
        if self.wire_format == "u8" and x.dtype != np.uint8:
            raise ValueError(
                "this engine's wire format is uint8 [0,255]; got dtype "
                f"{x.dtype} (pass raw uint8 pixels, or build the engine "
                "with wire_format='f32')")
        if self.wire_format == "f32" and x.dtype == np.uint8:
            raise ValueError(
                "this engine's wire format is float32 [-1,1]; got uint8 "
                "(normalize host-side, or build the engine with "
                "wire_format='u8')")
        if z is None:
            z = self.make_z(seed)
        req = _Request(x.astype(self._wire_dtype, copy=False),
                       np.asarray(z, np.float32))
        with self._lifecycle_lock:
            if not self._running:        # raced a concurrent stop()
                raise RuntimeError("engine not started")
            self._q.put(req)
        return req.future

    def translate_sync(self, x: np.ndarray, z: Optional[np.ndarray] = None,
                       seed: int = 0, timeout: float = 120.0) -> np.ndarray:
        return self.submit(x, z=z, seed=seed).result(timeout=timeout)

    def encode_style(self, x: np.ndarray) -> np.ndarray:
        """Style code of one example image (H,W,3) — uint8 [0,255] or
        float32 [-1,1]. Style-guided serving: feed the returned vector back
        as ``submit(..., z=...)`` to translate every request in this
        image's style (the --style_image capability of the CLI, SURVEY
        §3.4). A direct (unbatched) translator dispatch: style encoding is
        an infrequent setup call, not the serving hot path."""
        if self.all_members:
            # style codes are per-member (each member has its own
            # StyleEncoder); the ensemble engine shares one PRIOR draw
            # across members — use a single-member server to style-guide
            raise ValueError("encode_style is per-member; run a "
                             "single-member server for style-guided "
                             "serving")
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = (x.astype(np.float32) - 127.5) / 127.5
        z = self.translator.encode_style(self.params, x[None])
        return z.cpu().numpy()[0]

    # -- worker -------------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for the first request, then coalesce until max_batch or
        the deadline elapses; each request is stamped as it is taken."""
        first = self._q.get()
        if first is None:
            return []
        first.t_taken = time.perf_counter_ns()
        batch = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:                    # stop sentinel: put it back
                self._q.put(None)
                break
            nxt.t_taken = time.perf_counter_ns()
            batch.append(nxt)
        return batch

    def _run_dispatch(self):
        while self._running:
            bid = self._batch_id
            with trace.span("engine.collect", bid):
                batch = self._collect()
            if not batch:
                continue
            self._batch_id += 1
            closed = time.perf_counter_ns()
            try:
                dev, ready = self._dispatch(batch, bid)
            except Exception as e:             # fail the batch, keep serving
                self._fail(batch, e)
                continue
            item = (batch, dev, ready, bid, closed, time.perf_counter_ns())
            if self.pipeline:
                # bounded: 2-deep backpressure
                with trace.span("engine.handoff", bid):
                    self._ready.put(item)
            else:
                self._finish(*item)
        if self.pipeline:                      # stop(): let the reader drain
            self._ready.put(None)

    def _run_readback(self):
        while True:
            item = self._ready.get()
            if item is None:
                return
            self._finish(*item)

    def _fail(self, batch: List[_Request], e: Exception):
        for r in batch:
            _set_exception(r.future, e)

    def _device_call(self, x: np.ndarray, z: np.ndarray, bid: int = 0):
        if self.graphs:
            # one capture or replay at a time (warmup() on the caller's
            # thread may meet a batch on the dispatch thread): the buckets
            # share one memory pool and a bucket its static inputs. On a
            # card the inputs are pinned here, so that the call's copies
            # into its static inputs are asynchronous. The output is copied
            # out: the next replay overwrites it while this batch may still
            # be read back (a sharded call's gather has copied it already)
            with trace.span("engine.stage", bid):
                xz = (torch.from_numpy(x), torch.from_numpy(z))
                if self.translator.device.type == "cuda":
                    xz = tuple(t.pin_memory() for t in xz)
            with self._graph_lock:
                self.replays += 1
                with trace.span("engine.replay", bid):
                    out = self.captured(x.shape[0])(*xz)
                if self.translator.axis_names:
                    return out
                with trace.span("engine.clone", bid):
                    return out.clone()
        with trace.span("engine.eager", bid):
            if self.all_members:
                if self.wire_format == "u8":
                    return self.translator.translate_all_u8io_device(
                        self.params, x, z)
                return self.translator.translate_all_u8_device(self.params,
                                                               x, z)
            if self.wire_format == "u8":
                return self.translator.translate_u8io_device(self.params, x,
                                                             z=z)
            return self.translator.translate_u8_device(self.params, x, z=z)

    def _dispatch(self, batch: List[_Request], bid: int):
        """Assemble + pad to the bucket and launch the device computation;
        returns the device tensor WITHOUT waiting for the result, and on
        CUDA an event recorded right after the batch's work."""
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        h, w = self.image_hw
        with trace.span("engine.assemble", bid):
            x = np.zeros((bucket, h, w, 3), self._wire_dtype)
            z = np.zeros((bucket, self.style_dim), np.float32)
            for i, r in enumerate(batch):
                x[i] = r.x
                z[i] = r.z
        with self._stats_lock:
            st = self.stats
            st.batches += 1
            st.padded_rows += bucket - n
            st.batch_hist[bucket] = st.batch_hist.get(bucket, 0) + 1
        dev = self._device_call(x, z, bid)
        if not dev.is_cuda:
            return dev, None
        # while tracing, a timing event: its record places the batch's end
        # on the device's clock
        ready = torch.cuda.Event(enable_timing=trace.enabled())
        ready.record()
        return dev, ready

    def _to_host(self, dev: torch.Tensor, ready, bid: int) -> np.ndarray:
        """Copy one batch's result to the host (waits for the device). On
        CUDA the copy runs on the engine's own stream after waiting for
        that batch's event alone: on the launching stream it would also
        wait for the next batch, which the dispatch thread has already
        queued behind it, and the pipeline would not overlap. The wait and
        the copy are one call: a host wait for the event first, then the
        copy, frees the reader sooner, and the dispatch thread then closes
        smaller batches (on an H100, 256 px images at 920 a second: 12-16
        a batch against 40-45). The ``engine.d2h`` record carries the
        event instead, whose time on the device's clock splits the two."""
        t0 = time.perf_counter_ns()
        if ready is None:
            out = dev.numpy()
        else:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(ready)
                out = dev.cpu().numpy()
        trace.add("engine.d2h", t0, time.perf_counter_ns(), bid, ready)
        return out

    def _finish(self, batch: List[_Request], dev, ready, bid: int,
                closed: int, launched: int):
        """Copy the result to the host (waits for the device) and resolve
        the batch's futures; then add each request's stages to the stats
        (and, while tracing, record it)."""
        try:
            out = self._to_host(dev, ready, bid)
        except Exception as e:
            self._fail(batch, e)
            return
        host = time.perf_counter_ns()
        with self._stats_lock:
            st = self.stats
            st.requests += len(batch)
            st.images_done += len(batch)
        resolved = []
        with trace.span("engine.resolve", bid):
            for i, r in enumerate(batch):
                # all-members batches come back (N, bucket, H, W, 3)
                _set_result(r.future,
                            out[:, i] if self.all_members else out[i])
                resolved.append(time.perf_counter_ns())
        with self._stats_lock:
            st = self.stats
            st.resolved += len(batch)
            ns = st.stage_ns
            for r, t in zip(batch, resolved):
                ns["queue"] += r.t_taken - r.t_submit
                ns["coalesce"] += closed - r.t_taken
                ns["dispatch"] += launched - closed
                ns["inflight"] += host - launched
                ns["resolve"] += t - host
        if trace.enabled():
            for r, t in zip(batch, resolved):
                trace.add("engine.request", r.t_submit, t, bid,
                          (r.t_taken, closed, launched, host))
