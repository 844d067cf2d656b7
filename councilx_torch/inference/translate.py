"""Batched translation (reference test_on_folder.py, SURVEY.md §3.4).

Counterpart of ``councilx/inference/translate.py::Translator``. The JAX
package's jitted functions become plain methods under
``torch.inference_mode()``, and its vmapped member axis becomes a loop over
the members' ``AdaINGen`` modules. On a card, :meth:`Translator.captured`
captures the serving methods (``CAPTURED``) as CUDA graphs, one per
(method, members, batch, image size) -- the counterpart of their jitted
executables -- which the serving engine replays (``utils/graphs.py``).

``params`` is one member's ``AdaINGen`` or a sequence of them (the
council); ``member=i`` picks one out of a sequence. Build them with
:meth:`Translator.load_members` (state dicts) or
:meth:`Translator.init_members` (random weights from a seed).

Inputs may be numpy arrays or tensors; they are moved to the translator's
device. Randomness is a ``torch.Generator`` (CPU), or an explicit ``z``.

W8A8 serving (``cfg.quant``: "w8a8", or "w8a8_static" with the calibrated
``quant_stats`` tree of ``councilx_torch.tools.calibrate_quant`` or the JAX
package's tool) quantizes the convs of ``cfg.quant_scope``
(``nn/generator.py``); each member's int8 weights are made when the
translator takes its weights. ``parity_mode`` turns quant off.

Serving over several devices, in one process: :class:`ShardedTranslator`
splits the batch over a list of devices (each holds every member),
:class:`MemberShardedTranslator` the members over a ``(D, K)`` grid
(``parallel.mesh.make_member_mesh``). Each device's share is launched from
its own host thread, so their host time overlaps, and the results come
together on the first device in order. A list may name one card more than
once (a one-card machine runs these paths so). On a card their
``captured`` holds one captured call per device (:class:`ShardedCall`),
the counterpart of the JAX package's jitted ``shard_map`` calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from councilx_torch.ckpt.torch_convert import (quant_stat_names,
                                              quant_stats_to_port)
from councilx_torch.config import Config
from councilx_torch.nn.blocks import init_parameters
from councilx_torch.nn.generator import (AdaINGen, composite_with_mask,
                                         engine_kwargs)
from councilx_torch.utils.graphs import CaptureContext, CapturedCall

Members = Union[AdaINGen, Sequence[AdaINGen]]

# the methods a Translator captures, each called (members, x, z): the
# engine's -> uint8 on the device, with uint8 ("u8io") or float32 [-1, 1]
# input, one member or all under one z; the GUI's -> (float32 images,
# masks | None), one member, or all with a z each (z (N, B, style_dim))
CAPTURED = ("translate_u8io_device", "translate_u8_device",
            "translate_all_u8io_device", "translate_all_u8_device",
            "translate", "translate_all_members")


def _member_ids(params) -> tuple:
    """The ids of every module in ``params`` (a module, or nested tuples
    and lists of them): a captured call's key."""
    if isinstance(params, (list, tuple)):
        return tuple(i for p in params for i in _member_ids(p))
    return (id(params),)


def _u8_from_unit(out: torch.Tensor) -> torch.Tensor:
    """[-1, 1] f32 -> uint8: scale, clamp, round (denormalize_to_uint8)."""
    arr = ((out + 1.0) * 0.5).clamp(0.0, 1.0)
    return (arr * 255.0 + 0.5).to(torch.uint8)


def _unit_from_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] f32 with the CLI's exact (x - 127.5) / 127.5."""
    return (x_u8.to(torch.float32) - 127.5) / 127.5


class Translator:
    """The generator definition and translate functions for one config, on
    ``device``: the card unless the caller asks for another device (the
    CPU tests pass ``device="cpu"``)."""

    # the serving layout (the sharded translators below): no device axes,
    # the batch whole
    axis_names: Tuple[str, ...] = ()
    data_size = 1

    def __init__(self, cfg: Config, quant_stats=None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.focus = cfg.council.focus_enabled
        self.dtype = (torch.float32 if cfg.parity_mode
                      or cfg.compute_dtype == "float32" else torch.bfloat16)
        self.mask_activation = cfg.council.mask_activation
        self.quant = "none" if cfg.parity_mode else cfg.quant
        if self.quant == "w8a8_static" and quant_stats is None:
            raise ValueError(
                "quant='w8a8_static' needs calibrated stats: pass "
                "quant_stats= (from councilx_torch.tools.calibrate_quant)")
        if cfg.quant == "w8a8_calib":
            raise ValueError(
                "quant='w8a8_calib' is the calibration-pass mode; use "
                "councilx_torch.tools.calibrate_quant, then serve with "
                "quant='w8a8_static'")
        # {port module name: absmax} of the static mode's scoped convs
        self.quant_stats = None
        if quant_stats is not None and self.quant == "w8a8_static":
            self.quant_stats = quant_stats_to_port(quant_stats, cfg)
            self._validate_quant_stats()
        # captured serving calls (captured()), and their stream and pool
        self._captured = {}
        self._capture_ctx = None

    def _validate_quant_stats(self) -> None:
        """Fail by name when the calibration does not cover quant_scope:
        stats recorded under "resblocks" lack the downsample and upsample
        convs that "heavy" quantizes. Extra entries are fine."""
        scope = self.cfg.quant_scope
        missing = ["/".join(path) for path, name in quant_stat_names(
            self.cfg.gen.n_downsample, self.cfg.gen.n_res)
            if (scope == "heavy" or "ResBlocks_0" in path)
            and name not in self.quant_stats]
        if missing:
            raise ValueError(
                f"quant_stats does not cover quant_scope='{scope}': missing "
                f"{missing[:4]}{'...' if len(missing) > 4 else ''} "
                f"({len(missing)} entries). Recalibrate with "
                "councilx_torch.tools.calibrate_quant under the SAME config "
                "(calibration scope must match serving scope).")

    # -- members ------------------------------------------------------------

    def make_gen(self, quant: Optional[str] = None) -> AdaINGen:
        """An AdaINGen of this config on this device (weights zero), its
        convs quantized as ``quant`` says (default: the translator's
        mode; the calibration tool asks for "w8a8_calib")."""
        cfg, g = self.cfg, self.cfg.gen
        gen = AdaINGen(
            input_dim=cfg.data.input_dim_a, dim=g.dim, style_dim=g.style_dim,
            n_downsample=g.n_downsample, n_res=g.n_res, activ=g.activ,
            pad_type=g.pad_type, mlp_dim=g.mlp_dim, mlp_n_blk=g.mlp_n_blk,
            focus_mask=self.focus,
            ln_precision="f32" if cfg.parity_mode else cfg.in_precision,
            ln_stats="two_pass" if cfg.parity_mode else cfg.norm_stats,
            mask_activation=self.mask_activation,
            quant=self.quant if quant is None else quant,
            quant_scope=cfg.quant_scope,
            **engine_kwargs(cfg), device=self.device)
        return gen.eval().requires_grad_(False)

    def _take(self, gen: AdaINGen) -> AdaINGen:
        """A member's quantized state, made as it takes its weights: the
        calibrated scales, and the int8 weights (a pure function of the
        weights, so made once, not per call)."""
        if self.quant_stats is not None:
            gen.set_quant_stats(self.quant_stats)
        gen.prepare_quant(self.dtype)
        return gen

    def load_members(self, state_dicts: Sequence[Mapping[str, torch.Tensor]]
                     ) -> List[AdaINGen]:
        """One AdaINGen per MUNIT-layout state dict (strict load). Drops
        the captured calls of earlier members."""
        self._captured.clear()
        gens = []
        for sd in state_dicts:
            gen = self.make_gen()
            gen.load_state_dict(sd, strict=True)
            gens.append(self._take(gen))
        return gens

    def init_members(self, n: int, seed: int) -> List[AdaINGen]:
        """n members with random weights (``cfg.init``) drawn in order
        from one ``torch.Generator`` seeded with ``seed``. Drops the
        captured calls of earlier members."""
        self._captured.clear()
        rng = torch.Generator().manual_seed(seed)
        gens = []
        for _ in range(n):
            gen = self.make_gen()
            init_parameters(gen, self.cfg.init, rng)
            gens.append(self._take(gen))
        return gens

    # -- captured calls -----------------------------------------------------

    def captured(self, method: str, params: Members, batch: int,
                 hw: Tuple[int, int]) -> CapturedCall:
        """``method`` (one of ``CAPTURED``) of ``params`` at ``batch`` rows
        of ``hw`` images, as a CUDA graph over static ``x`` and ``z``
        inputs: call it with host or device ``(x, z)`` of those shapes
        (``x`` uint8 for the u8io methods, else float32; ``z`` (batch,
        style_dim) float32, (N, batch, style_dim) for
        ``translate_all_members``) -> the graph's output, which the next
        replay overwrites. Built at first use -- one eager run on the
        capture's side stream, then the capture -- and kept, keyed by
        (method, members, batch, hw, dtype, quant mode and scope), until
        new members are loaded. The calls of one translator share one
        memory pool: replay them from one thread at a time. A graph reads
        the members' derived and int8 weights as its warm-up cached them
        (``nn/blocks.py``), so new weights come through
        :meth:`load_members`, which drops the calls, never in place."""
        if method not in CAPTURED:
            raise ValueError(f"captured: {method!r} is not one of "
                             f"{CAPTURED}")
        members = tuple(params) if isinstance(params, (list, tuple)) \
            else (params,)
        key = (method, _member_ids(members), batch, tuple(hw),
               self.dtype, self.quant, self.cfg.quant_scope)
        hit = self._captured.get(key)
        if hit is not None:
            return hit[1]
        if self._capture_ctx is None:
            self._capture_ctx = CaptureContext(self.device,
                                               "Translator.captured")
        ctx = self._capture_ctx
        h, w = hw
        x = torch.zeros((batch, h, w, 3), device=ctx.device,
                        dtype=torch.uint8 if "u8io" in method
                        else torch.float32)
        z = torch.zeros((len(members),) * (method == "translate_all_members")
                        + (batch, self.cfg.gen.style_dim), device=ctx.device)
        fn = getattr(self, method)

        def call(x, z):
            return fn(params, x, z)

        ctx.run(call, x, z)
        # the members stay referenced beside their call: the key holds
        # their ids
        self._captured[key] = (params, ctx.capture(
            call, [x, z], f"{method} of {len(members)} member(s) at batch "
            f"{batch} x {h}x{w}"))
        return self._captured[key][1]

    # -- helpers ------------------------------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        """Upload host data without blocking: a plain host-to-device copy
        synchronizes the stream, so the next batch's upload would wait for
        this batch's compute; a pinned, non-blocking one does not."""
        t = torch.as_tensor(a)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @staticmethod
    def _host_z(z, shape: Tuple[int, ...], rng: Optional[torch.Generator]):
        """``z``, or a standard normal draw of ``shape`` from ``rng`` (seed
        0 when None), on the host."""
        if z is None:
            if rng is None:
                rng = torch.Generator().manual_seed(0)
            z = torch.randn(shape, generator=rng)
        return z

    def _z(self, z, shape: Tuple[int, ...],
           rng: Optional[torch.Generator]) -> torch.Tensor:
        return self._to_device(self._host_z(z, shape, rng))

    @staticmethod
    def _pick(params: Members, member: Optional[int]) -> AdaINGen:
        return params[member] if member is not None else params

    # -- one member -----------------------------------------------------------

    def _translate(self, gen: AdaINGen, x: torch.Tensor, z: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x.to(self.dtype)
        out = gen.decode(gen.encode_content(x), z.to(self.dtype))
        if self.focus:
            x_t, mask = composite_with_mask(out, x, self.mask_activation)
            return x_t.float(), mask.float()
        return out.float(), None

    def _translate_u8(self, gen: AdaINGen, x: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
        """Translate and denormalize to uint8 on the device: the
        device->host copy is 4x smaller than f32."""
        return _u8_from_unit(self._translate(gen, x, z)[0])

    @torch.inference_mode()
    def translate(self, params: Members, x, z=None,
                  rng: Optional[torch.Generator] = None,
                  member: Optional[int] = None):
        """x (B,H,W,3) float in [-1,1] -> (images (B,H,W,3) f32 in [-1,1],
        mask (B,H,W,1) | None), on the device."""
        x = self._to_device(x)
        z = self._z(z, (x.shape[0], self.cfg.gen.style_dim), rng)
        return self._translate(self._pick(params, member), x, z)

    @torch.inference_mode()
    def translate_u8_device(self, params: Members, x, z=None,
                            rng: Optional[torch.Generator] = None,
                            member: Optional[int] = None) -> torch.Tensor:
        """uint8 (B,H,W,3) translations, left on the device (the serving
        engine reads them back on another thread)."""
        x = self._to_device(x)
        z = self._z(z, (x.shape[0], self.cfg.gen.style_dim), rng)
        return self._translate_u8(self._pick(params, member), x, z)

    def translate_u8(self, params: Members, x, z=None,
                     rng: Optional[torch.Generator] = None,
                     member: Optional[int] = None) -> np.ndarray:
        return self.translate_u8_device(params, x, z=z, rng=rng,
                                        member=member).cpu().numpy()

    @torch.inference_mode()
    def translate_u8io_device(self, params: Members, x_u8, z=None,
                              rng: Optional[torch.Generator] = None,
                              member: Optional[int] = None) -> torch.Tensor:
        """uint8 in, uint8 out, on the device: the serving wire format. The
        normalize runs on the device with the CLI's exact formula."""
        x = _unit_from_u8(self._to_device(x_u8))
        z = self._z(z, (x.shape[0], self.cfg.gen.style_dim), rng)
        return self._translate_u8(self._pick(params, member), x, z)

    def translate_u8io(self, params: Members, x_u8, z=None,
                       rng: Optional[torch.Generator] = None,
                       member: Optional[int] = None) -> np.ndarray:
        return self.translate_u8io_device(params, x_u8, z=z, rng=rng,
                                          member=member).cpu().numpy()

    @torch.inference_mode()
    def encode_style(self, params: Members, x,
                     member: Optional[int] = None) -> torch.Tensor:
        """Style code(s) (B, style_dim) f32 of example image(s) x
        (B,H,W,3) in [-1,1] — style-guided translation."""
        x = self._to_device(x).to(self.dtype)
        return self._pick(params, member).encode_style(x).float()

    # -- all members ------------------------------------------------------------

    @torch.inference_mode()
    def translate_all_members(self, members: Sequence[AdaINGen], x, z=None,
                              rng: Optional[torch.Generator] = None):
        """x (B,...), z (N,B,S) -> ((N,B,H,W,3) images, (N,B,H,W,1) masks |
        None): each member with its own style draw."""
        x = self._to_device(x)
        n = len(members)
        z = self._z(z, (n, x.shape[0], self.cfg.gen.style_dim), rng)
        outs = [self._translate(g, x, z[i]) for i, g in enumerate(members)]
        images = torch.stack([o[0] for o in outs])
        masks = (torch.stack([o[1] for o in outs]) if self.focus else None)
        return images, masks

    @torch.inference_mode()
    def translate_all_u8_device(self, members: Sequence[AdaINGen], x,
                                z) -> torch.Tensor:
        """Council-ensemble serving: x (B,...) and ONE z (B,S) shared by
        every member -> (N,B,H,W,3) uint8 on the device."""
        x = self._to_device(x)
        z = self._to_device(z)
        return torch.stack([self._translate_u8(g, x, z) for g in members])

    @torch.inference_mode()
    def translate_all_u8io_device(self, members: Sequence[AdaINGen], x_u8,
                                  z) -> torch.Tensor:
        """uint8-wire variant of :meth:`translate_all_u8_device`."""
        return self.translate_all_u8_device(
            members, _unit_from_u8(self._to_device(x_u8)), z)


class ShardedCall:
    """One serving method of a sharded translator at one global batch, as
    one captured call per device (``Translator.captured`` of that device's
    translator, :meth:`_MultiDevice.captured`). ``call(x, z)``, host or
    device tensors of the global shapes: each device's share of ``x`` and
    ``z`` is copied from the host (pinned) straight into that device's
    static buffers, every device replays from its own thread, and the
    results are gathered on the first device. The gather copies, so the
    result is the caller's: the next call's replays overwrite the graphs'
    outputs, not it (where the list names one card twice, moving an output
    to the first device is no copy, and only the concatenation's is)."""

    def __init__(self, translator: "_MultiDevice", method: str, params,
                 calls: Mapping[int, CapturedCall], name: str):
        self.translator, self.method, self.params = translator, method, params
        self.calls, self.name = calls, name

    @property
    def capture_seconds(self) -> float:
        """The devices' captures' seconds, summed (they run in turn)."""
        return sum(c.capture_seconds for c in self.calls.values())

    @property
    def replays(self) -> int:
        return min(c.replays for c in self.calls.values())

    def __call__(self, x, z):
        tr = self.translator
        x, z = torch.as_tensor(x), torch.as_tensor(z)
        if tr.device.type == "cuda":
            x, z = (t.pin_memory() if t.device.type == "cpu"
                    and not t.is_pinned() else t for t in (x, z))
        return tr._run(self.method, self.params, x, z, self.calls)


class _MultiDevice(Translator):
    """One :class:`Translator` per device, and one host thread per device
    that launches its share. A member is a tuple of its copies, one per
    device that holds it. A subclass says how a call splits
    (:meth:`_shares`) and how the shares' results come together
    (:meth:`_assemble`), and which methods of ``CAPTURED`` it serves."""

    served: Tuple[str, ...] = ()

    def __init__(self, cfg: Config, devices: Sequence, quant_stats=None):
        devices = [torch.device(d) for d in devices]
        super().__init__(cfg, quant_stats=quant_stats, device=devices[0])
        self._per_device = [Translator(cfg, quant_stats=quant_stats,
                                       device=d) for d in devices]
        self._pool = ThreadPoolExecutor(
            max_workers=len(devices), thread_name_prefix="councilx-shard")

    def init_members(self, n: int, seed: int) -> List[Tuple[AdaINGen, ...]]:
        """n members with the weights :meth:`Translator.init_members`
        draws, copied to every device that holds them."""
        cpu = Translator(dataclasses.replace(self.cfg, quant="none"),
                         device="cpu")
        return self.load_members([g.state_dict()
                                  for g in cpu.init_members(n, seed)])

    def _launch(self, jobs: Sequence[Tuple[int, Callable]]) -> list:
        """Run ``fn()`` for each ``(device index, fn)`` from the pool's
        threads, each inside its device; -> the results in order."""
        def run(job):
            i, fn = job
            dev = self._per_device[i].device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                return fn()

        return list(self._pool.map(run, jobs))

    def _check_batch(self, x) -> int:
        """-> rows per data shard."""
        if x.shape[0] % self.data_size:
            raise ValueError(
                f"global batch {x.shape[0]} not divisible by the serving "
                f"data-axis size {self.data_size} (the engine's bucket "
                "ladder guarantees this; pad manual calls)")
        return x.shape[0] // self.data_size

    def _shares(self, params, x, z) -> list:
        """``(device index, members, x rows, z)`` of each device's share
        of a call."""
        raise NotImplementedError

    def _assemble(self, outs: list):
        """The shares' results (in :meth:`_shares`' order) -> the call's."""
        raise NotImplementedError

    def _run(self, method: str, params, x, z,
             calls: Optional[Mapping[int, CapturedCall]] = None):
        """``method`` on every device's share, each from its device's
        thread -> the assembled result; with ``calls`` each share replays
        its device's captured call instead of running eagerly."""
        jobs = []
        for i, gens, xs, zs in self._shares(params, x, z):
            if calls is None:
                fn = (lambda t=self._per_device[i], gens=gens, xs=xs, zs=zs:
                      getattr(t, method)(gens, xs, zs))
            else:
                fn = lambda c=calls[i], xs=xs, zs=zs: c(xs, zs)
            jobs.append((i, fn))
        return self._assemble(self._launch(jobs))

    def _gather(self, outs: Sequence[torch.Tensor], dim: int = 0
                ) -> torch.Tensor:
        """The outputs concatenated on the first device: always a new
        tensor, even from one output on that device."""
        return torch.cat([o.to(self.device) for o in outs], dim=dim)

    def captured(self, method: str, params, batch: int,
                 hw: Tuple[int, int]) -> ShardedCall:
        """``method`` (one of ``served``) of ``params`` at a global
        ``batch`` of ``hw`` images as a :class:`ShardedCall`: each device's
        translator captures its share (``Translator.captured``: one eager
        run on its capture stream, then the capture), one device after the
        other, each entered from the pool's thread. Kept, keyed by
        (method, members, batch, hw), until new members are loaded; the
        calls replay from one thread at a time, as one translator's."""
        if method not in self.served:
            raise ValueError(f"captured: {type(self).__name__} serves "
                             f"{self.served}, not {method!r}")
        key = (method, _member_ids(params), batch, tuple(hw))
        hit = self._captured.get(key)
        if hit is not None:
            return hit[1]
        h, w = hw
        x = torch.zeros((batch, h, w, 3), dtype=torch.uint8 if "u8io" in
                        method else torch.float32)
        z = torch.zeros((self.cfg.council.council_size,)
                        * (method == "translate_all_members")
                        + (batch, self.cfg.gen.style_dim))
        calls = {}
        for i, gens, xs, _ in self._shares(params, x, z):
            t = self._per_device[i]
            calls[i] = self._launch([(i, lambda t=t, gens=gens, n=len(xs):
                                      t.captured(method, gens, n, hw))])[0]
        self._captured[key] = (params, ShardedCall(
            self, method, params, calls,
            f"{type(self).__name__} {method} at batch {batch} x {h}x{w} "
            f"over {len(calls)} devices"))
        return self._captured[key][1]

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class ShardedTranslator(_MultiDevice):
    """Translator with the batch split over ``devices``: serving-side data
    parallelism (counterpart of the JAX package's ``ShardedTranslator``
    over a ``("data",)`` mesh). Every device holds a copy of the weights,
    quantized ones included; each call splits the batch in contiguous
    equal slices, translates slice i on device i, and concatenates the
    results on the first device. Images are independent, so each slice's
    numbers are those of the one-device call at the slice's batch.

    A member (:meth:`load_members`) is a tuple of its copies, one per
    device; ``captured`` takes one member."""

    axis_names = ("data",)
    served = ("translate_u8io_device", "translate_u8_device", "translate")

    def __init__(self, cfg: Config, devices: Sequence, quant_stats=None):
        super().__init__(cfg, devices, quant_stats=quant_stats)
        self.data_size = len(self._per_device)

    def load_members(self, state_dicts: Sequence[Mapping[str, torch.Tensor]]
                     ) -> List[Tuple[AdaINGen, ...]]:
        """Each member's copies, one per device (strict loads). Drops the
        captured calls of earlier members."""
        self._captured.clear()
        per = [t.load_members(state_dicts) for t in self._per_device]
        return list(zip(*per))

    def _shares(self, reps, x, z) -> list:
        n = self._check_batch(x)
        return [(i, reps[i], x[i * n:(i + 1) * n], z[i * n:(i + 1) * n])
                for i in range(self.data_size)]

    def _assemble(self, outs: list):
        if isinstance(outs[0], tuple):
            return tuple(None if parts[0] is None else self._gather(parts)
                         for parts in zip(*outs))
        return self._gather(outs)

    def translate(self, params, x, z=None,
                  rng: Optional[torch.Generator] = None,
                  member: Optional[int] = None):
        z = self._host_z(z, (x.shape[0], self.cfg.gen.style_dim), rng)
        return self._run("translate", self._pick(params, member), x, z)

    def translate_u8_device(self, params, x, z=None,
                            rng: Optional[torch.Generator] = None,
                            member: Optional[int] = None) -> torch.Tensor:
        z = self._host_z(z, (x.shape[0], self.cfg.gen.style_dim), rng)
        return self._run("translate_u8_device", self._pick(params, member),
                         x, z)

    def translate_u8io_device(self, params, x_u8, z=None,
                              rng: Optional[torch.Generator] = None,
                              member: Optional[int] = None) -> torch.Tensor:
        z = self._host_z(z, (x_u8.shape[0], self.cfg.gen.style_dim), rng)
        return self._run("translate_u8io_device", self._pick(params, member),
                         x_u8, z)

    def encode_style(self, params, x, member: Optional[int] = None
                     ) -> torch.Tensor:
        """Style codes by the first device's copy."""
        return self._per_device[0].encode_style(
            self._pick(params, member)[0], x)


class MemberShardedTranslator(_MultiDevice):
    """Council-ensemble translation with the members split over the
    ``council`` axis of a :class:`~councilx_torch.parallel.mesh.DeviceGrid`
    (counterpart of the JAX package's ``MemberShardedTranslator``): device
    ``(d, c)`` holds members ``[c*m, (c+1)*m)``, ``m = N / K``, and
    translates batch slice d with them (on a ``("council",)`` grid the
    batch is whole). The outputs come together on the first device in
    member order. Each member's numbers are those of the one-device
    all-members call at the slice's batch.

    A member (:meth:`load_members`) is a tuple of its copies, one per data
    row. Quantized ensemble serving is refused: the activation scales are
    calibrated per member."""

    served = ("translate_all_u8io_device", "translate_all_u8_device",
              "translate_all_members")

    def __init__(self, cfg: Config, grid, quant_stats=None):
        axes = tuple(grid.axis_names)
        if axes not in (("council",), ("data", "council")):
            raise ValueError(
                "MemberShardedTranslator takes a ('council',) or "
                "('data','council') grid (parallel.mesh.make_member_mesh), "
                f"got axes {axes}")
        n = cfg.council.council_size
        k = len(grid.devices[0])
        if n % k:
            raise ValueError(f"council_size {n} not divisible by member-"
                             f"grid size {k}")
        if quant_stats is not None:
            raise ValueError("quantized ensemble serving is unsupported: "
                             "activation scales are calibrated per member "
                             "(calibrate_quant --member)")
        super().__init__(cfg, [dv for row in grid.devices for dv in row])
        self.grid = grid
        self.axis_names = axes
        self.data_size = len(grid.devices)
        self.k, self.m = k, n // k

    def _cell(self, d: int, c: int) -> int:
        return d * self.k + c

    def load_members(self, state_dicts: Sequence[Mapping[str, torch.Tensor]]
                     ) -> List[Tuple[AdaINGen, ...]]:
        """Member j's copies, one per data row d, on device (d, j // m).
        Drops the captured calls of earlier members."""
        self._captured.clear()
        return [tuple(self._per_device[self._cell(d, j // self.m)]
                      .load_members([sd])[0]
                      for d in range(self.data_size))
                for j, sd in enumerate(state_dicts)]

    def _shares(self, members, x, z) -> list:
        """Cell (d, c), in device order: members ``[c*m, (c+1)*m)``' row-d
        copies on rows d of ``x``; ``z`` (B, S) is shared by the members,
        a (N, B, S) ``z`` is sliced by member too."""
        n = self._check_batch(x)
        m = self.m
        out = []
        for d in range(self.data_size):
            rows = slice(d * n, (d + 1) * n)
            for c in range(self.k):
                gens = [members[j][d] for j in range(c * m, (c + 1) * m)]
                zs = (z[c * m:(c + 1) * m, rows] if z.ndim == 3
                      else z[rows])
                out.append((self._cell(d, c), gens, x[rows], zs))
        return out

    def _assemble(self, outs: list):
        """The cells' (m, n, ...) results -> (N, B, ...) in member order."""
        def grid(pick):
            return self._gather(
                [self._gather([pick(outs[self._cell(d, c)])
                               for d in range(self.data_size)], dim=1)
                 for c in range(self.k)])

        if isinstance(outs[0], tuple):
            return tuple(None if part is None else
                         grid(lambda o, i=i: o[i])
                         for i, part in enumerate(outs[0]))
        return grid(lambda o: o)

    def translate_all_u8_device(self, members, x, z) -> torch.Tensor:
        return self._run("translate_all_u8_device", members, x, z)

    def translate_all_u8io_device(self, members, x_u8, z) -> torch.Tensor:
        return self._run("translate_all_u8io_device", members, x_u8, z)

    def translate_all_members(self, members, x, z=None,
                              rng: Optional[torch.Generator] = None):
        z = self._host_z(z, (self.cfg.council.council_size, x.shape[0],
                             self.cfg.gen.style_dim), rng)
        return self._run("translate_all_members", members, x, z)


def denormalize_to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8, matching the reference's save path
    (vutils.save_image((out+1)/2): scale, clamp, round)."""
    arr = (np.asarray(img, dtype=np.float32) + 1.0) * 0.5
    arr = np.clip(arr, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)
