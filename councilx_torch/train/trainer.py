"""Council trainer: per-member modules and the train step, in PyTorch.

Counterpart of ``councilx/train/trainer.py`` (reference
trainer_council.py::Council_Trainer). The JAX package stacks the council on
a leading parameter axis and vmaps it inside one jitted step; PyTorch runs
eagerly, so here each member is its own ``AdaINGen`` / ``MsImageDis`` and
the member axis is a loop. The step keeps the JAX package's order and
semantics: council discriminators, then domain discriminators, then the
generators, which see the freshly updated discriminators; three Adam groups
with torch-Adam semantics (``train/optim.py``); the same metric names.

Fakes and z: ``train_step`` takes injected z codes (a dict keyed by phase
stream, each a dict keyed by direction, as :func:`draw_phase_zs` returns
them), or draws them from the state's ``torch.Generator``. With
``z_mode="shared"`` the discriminator phases' detached fakes are the very
member translations the generator phase differentiates (XLA CSEs exactly
this in the JAX step): they are computed once, with autograd, before the
discriminator updates, and detached for those. That costs the memory of the
discriminator phases' graphs on top of the translation's, and saves one
full council forward per direction and step. With ``gen_member_chunks > 1``
or another ``z_mode`` the fakes are computed under ``no_grad``.

Multi-GPU (``councilx_torch/parallel``): one process per GPU, each running
this step on its slice of the layout -- the members ``[member_offset,
member_offset + n_local)`` and the rows of data shard ``data_index`` of
``data_size`` -- with the collectives in five hooks that are identities
here: :meth:`_gather_members`, :meth:`_council_dis`, :meth:`_reduce_grads`,
:meth:`_all_ok` and :meth:`_reduce_metrics`.

``vgg_w > 0`` adds MUNIT's VGG16 perceptual loss (``nn/vgg.py``) with
frozen weights from ``vgg_model_path``, outside the state and the
optimizers, as the JAX trainer keeps ``vgg_params``. ``remat_stages``
recomputes the generators' encoder and decoder stages in the backward
(``nn/generator.py``); with ``remat`` the checkpoints nest.

Refused on purpose: ``dis.norm`` ``sn`` and ``bn``. The port's
``MsImageDis`` has both (held against the JAX modules), but the JAX trainer
cannot train them either: it applies the discriminators with their
``params`` alone (``councilx/train/trainer.py``, ``_dis_apply`` /
``_cdis_apply``), so its first step misses the ``spectral_stats`` /
``batch_stats`` collections.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from councilx_torch.config import Config
from councilx_torch.losses.council import council_dis_loss, council_gen_loss
from councilx_torch.losses.focus import (mask_binary_loss, mask_size_loss,
                                         mask_tv_loss)
from councilx_torch.losses.gan import gan_dis_loss, gan_gen_loss
from councilx_torch.nn.blocks import init_parameters
from councilx_torch.nn.discriminator import MsImageDis
from councilx_torch.nn.generator import AdaINGen, composite_with_mask
from councilx_torch.nn.vgg import (compute_vgg_loss, load_vgg,
                                   vgg_target_features)
from councilx_torch.train.optim import Adam, AdamState, make_optimizers

GROUPS = ("gen", "dis", "cdis")


def draw_phase_zs(draw: Callable[[int], Any], directions: Sequence[str],
                  z_mode: str):
    """Per-phase style draws, as the JAX package's ``draw_phase_zs``.

    ``draw(fold)`` produces one (N, B, style_dim) draw; fold families:
    gen = di, dis fakes = 100 + di, cdis fakes = 200 + di. Returns
    ``(zs_gen, zs_cdis, zs_dis)`` dicts keyed by direction -- the same dict
    object where phases share a stream."""
    zs_gen = {d: draw(di) for di, d in enumerate(directions)}
    if z_mode == "shared":
        return zs_gen, zs_gen, zs_gen
    zs_dis = {d: draw(100 + di) for di, d in enumerate(directions)}
    if z_mode == "dis_shared":
        return zs_gen, zs_dis, zs_dis
    if z_mode != "per_phase":
        raise ValueError(f"unsupported z_mode: {z_mode}")
    zs_cdis = {d: draw(200 + di) for di, d in enumerate(directions)}
    return zs_gen, zs_cdis, zs_dis


@dataclass
class TrainState:
    """Everything that changes during training. ``gen``/``dis``/``cdis``
    hold N member modules per direction; ``train_step`` updates their
    parameters in place. ``generator`` draws the z codes when none are
    injected."""

    step: int
    generator: torch.Generator
    gen: Dict[str, List[AdaINGen]]
    dis: Dict[str, List[MsImageDis]]
    cdis: Dict[str, List[MsImageDis]]
    opt_gen: AdamState
    opt_dis: AdamState
    opt_cdis: AdamState

    def state_dicts(self) -> Dict[str, Dict[str, List[Dict[str,
                                                          torch.Tensor]]]]:
        """``{direction: {group: N MUNIT-layout state dicts}}``: copies on
        the CPU, which later steps leave as they are."""
        return {d: {grp: [{k: v.detach().to("cpu", copy=True)
                           for k, v in m.state_dict().items()}
                          for m in getattr(self, grp)[d]]
                    for grp in GROUPS}
                for d in self.gen}

    def snapshot(self) -> Dict[str, Any]:
        """Everything :meth:`CouncilTrainer.restore_state` needs to go on
        exactly where this state is (the checkpoint payload of
        ``ckpt.manager``): the step, the parameters as
        :meth:`state_dicts`, the three optimizer states and the z
        generator's state, all copied to the CPU before this returns."""
        def host(ts):
            return [t.detach().to("cpu", copy=True) for t in ts]

        return {
            "step": int(self.step),
            "params": self.state_dicts(),
            "opt": {grp: {"count": opt.count.detach().to("cpu", copy=True),
                          "mu": host(opt.mu), "nu": host(opt.nu)}
                    for grp, opt in (("gen", self.opt_gen),
                                     ("dis", self.opt_dis),
                                     ("cdis", self.opt_cdis))},
            "generator": self.generator.get_state()}


def group_params(modules: Mapping[str, Sequence[torch.nn.Module]]
                 ) -> List[torch.nn.Parameter]:
    """One optimizer group's parameters: by direction, member, then
    registration order."""
    return [p for ms in modules.values() for m in ms for p in m.parameters()]


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """d loss / d params; zeros where a parameter does not reach the loss
    (as JAX's grad gives)."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(gs, params)]


class CouncilTrainer:
    """Builds the council's modules and optimizers and runs the train step
    on ``device``: the card unless the caller asks for another device (the
    CPU tests pass ``device="cpu"``)."""

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.dis.norm in ("sn", "bn"):
            raise ValueError(
                f"dis.norm={cfg.dis.norm!r}: the discriminators' "
                "spectral_stats/batch_stats are not trained, here as in the "
                "JAX reference trainer, which applies the discriminators "
                "with their params alone (councilx/train/trainer.py "
                "_dis_apply/_cdis_apply) and fails at its first step; "
                "nn.discriminator.MsImageDis has both norms")
        self.cfg = cfg
        self.device = torch.device(device)
        self.n = cfg.council.council_size
        self.directions = [d for d, on in (("a2b", cfg.do_a2b),
                                           ("b2a", cfg.do_b2a)) if on]
        self.focus = cfg.council.focus_enabled
        self.gan_type = cfg.dis.gan_type
        self.conditional = cfg.council.council_conditional_input
        self.mask_activation = cfg.council.mask_activation
        # parity mode forces f32, f32 two-pass LayerNorm statistics and the
        # reference engines (the port has only those)
        self.dtype = (torch.float32 if cfg.parity_mode
                      or cfg.compute_dtype == "float32" else torch.bfloat16)
        self.ln_precision = "f32" if cfg.parity_mode else cfg.in_precision
        self.ln_stats = "two_pass" if cfg.parity_mode else cfg.norm_stats
        self.cdis_input_dim = cfg.data.input_dim_a * (
            2 if self.conditional else 1)
        self.gen_tx, self.dis_tx, self.cdis_tx = make_optimizers(cfg)
        self.has_council = self.n > 1 and cfg.council.council_w > 0
        # this process's slice of the layout (parallel/ narrows it): all
        # members and the whole batch here
        self.member_offset, self.n_local = 0, self.n
        self.data_index, self.data_size = 0, 1
        # MUNIT's VGG perceptual loss: frozen weights, in no state
        self.vgg = None
        if cfg.vgg_w:
            path = cfg.extras.get("vgg_model_path")
            if not path:
                raise ValueError(
                    "vgg_w > 0 requires extras.vgg_model_path (a converted "
                    "VGG16 .npz, see tools/convert_vgg_pt.py, or a torch "
                    "VGG16 state dict)")
            self.vgg = load_vgg(path, device=self.device)

    # ------------------------------------------------------------------
    # modules and state
    # ------------------------------------------------------------------

    def make_gen(self) -> AdaINGen:
        cfg, g = self.cfg, self.cfg.gen
        return AdaINGen(
            input_dim=cfg.data.input_dim_a, dim=g.dim, style_dim=g.style_dim,
            n_downsample=g.n_downsample, n_res=g.n_res, activ=g.activ,
            pad_type=g.pad_type, mlp_dim=g.mlp_dim, mlp_n_blk=g.mlp_n_blk,
            focus_mask=self.focus, ln_precision=self.ln_precision,
            ln_stats=self.ln_stats, mask_activation=self.mask_activation,
            remat_stages=cfg.remat_stages, device=self.device)

    def make_dis(self, input_dim: int) -> MsImageDis:
        d = self.cfg.dis
        return MsImageDis(input_dim=input_dim, dim=d.dim, n_layer=d.n_layer,
                          norm=d.norm, activ=d.activ,
                          num_scales=d.num_scales, pad_type=d.pad_type,
                          device=self.device)

    def _make_member(self, grp: str):
        if grp == "gen":
            return self.make_gen()
        return self.make_dis(self.cfg.data.input_dim_a if grp == "dis"
                             else self.cdis_input_dim)

    def _make_members(self):
        """This trainer's members: ``n_local`` of each group and
        direction."""
        return {d: {grp: [self._make_member(grp)
                          for _ in range(self.n_local)] for grp in GROUPS}
                for d in self.directions}

    def _local(self, seq: Sequence) -> list:
        """This trainer's members of a list over all N members."""
        return list(seq[self.member_offset:self.member_offset
                        + self.n_local])

    def _local_tensors(self, ts: Sequence, per_member: int) -> list:
        """This trainer's entries of a group's tensors listed, as
        :func:`group_params` lists them, over all N members."""
        per_dir = self.n * per_member
        lo = self.member_offset * per_member
        hi = lo + self.n_local * per_member
        return [t for di in range(len(self.directions))
                for t in ts[di * per_dir + lo:di * per_dir + hi]]

    def _state(self, members, seed: int) -> TrainState:
        mods = {grp: {d: members[d][grp] for d in self.directions}
                for grp in GROUPS}
        return TrainState(
            step=0, generator=torch.Generator().manual_seed(seed),
            gen=mods["gen"], dis=mods["dis"], cdis=mods["cdis"],
            opt_gen=self.gen_tx.init(group_params(mods["gen"])),
            opt_dis=self.dis_tx.init(group_params(mods["dis"])),
            opt_cdis=self.cdis_tx.init(group_params(mods["cdis"])))

    def init_state(self, seed: int = 0) -> TrainState:
        """Random weights drawn in order from one ``torch.Generator``:
        per direction, N generators (``cfg.init``, kaiming by default), N
        discriminators and N council discriminators (gaussian)."""
        rng = torch.Generator().manual_seed(seed)
        members = self._make_members()
        for d in self.directions:
            for grp in GROUPS:
                init = self.cfg.init if grp == "gen" else "gaussian"
                # every member's draws, in order; the members of other
                # processes are drawn into modules that are dropped
                for i in range(self.n):
                    j = i - self.member_offset
                    m = (members[d][grp][j] if 0 <= j < self.n_local
                         else self._make_member(grp))
                    init_parameters(m, init, rng)
        z_seed = int(torch.randint(2 ** 62, (1,), generator=rng))
        return self._state(members, z_seed)

    def load_state(self, state_dicts, seed: int = 0) -> TrainState:
        """A fresh state (step 0, new optimizer moments) from
        ``{direction: {group: N state dicts}}`` (MUNIT layout, strict);
        ``seed`` seeds the z draws."""
        members = self._make_members()
        for d in self.directions:
            for grp in GROUPS:
                sds = state_dicts[d][grp]
                if len(sds) != self.n:
                    raise ValueError(f"{d}/{grp}: {len(sds)} state dicts for "
                                     f"a council of {self.n}")
                for m, sd in zip(members[d][grp], self._local(sds)):
                    m.load_state_dict(sd, strict=True)
        return self._state(members, seed)

    def restore_state(self, payload: Mapping[str, Any]) -> TrainState:
        """The ``TrainState`` that :meth:`TrainState.snapshot` saved:
        parameters, Adam moments and counts, the step and the z
        generator's state, on this trainer's device (counterpart of the
        JAX trainer's ``place_state`` of a restored snapshot). A resumed
        run then steps exactly as the uninterrupted one."""
        state = self.load_state(payload["params"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
        for grp in GROUPS:
            mods = getattr(state, grp)
            params = group_params(mods)
            per_member = len(list(mods[self.directions[0]][0].parameters()))
            saved = payload["opt"][grp]
            local = {}
            for key in ("mu", "nu"):
                full = saved[key]
                local[key] = self._local_tensors(full, per_member)
                if len(full) != len(self.directions) * self.n * per_member \
                        or any(t.shape != p.shape
                               for t, p in zip(local[key], params)):
                    raise ValueError(f"snapshot: {grp} optimizer {key} does "
                                     f"not match the {grp} parameters")
            setattr(state, f"opt_{grp}", AdamState(
                count=saved["count"].to(self.device, torch.int32),
                mu=[t.to(self.device) for t in local["mu"]],
                nu=[t.to(self.device) for t in local["nu"]]))
        return state

    def snapshot(self, state: TrainState) -> Optional[Dict[str, Any]]:
        """The checkpoint payload of ``state`` (:meth:`TrainState.snapshot`)
        in the one-process layout; None on a process that writes no
        snapshot (parallel/)."""
        return state.snapshot()

    # ------------------------------------------------------------------
    # model application
    # ------------------------------------------------------------------

    def _run(self, fn: Callable, *args):
        """fn(*args), its activations recomputed in the backward under
        ``cfg.remat``."""
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def _translate_members(self, gens: Sequence[AdaINGen], x: torch.Tensor,
                           z: torch.Tensor):
        """All members translate the same batch: x (B,H,W,C), z (N,B,S) ->
        (x_t (N,B,H,W,C), mask (N,B,H,W,1) | None, content (N,B,h,w,Cc))."""
        outs, contents = [], []
        def one(x, z_i, gen):
            c = gen.encode_content(x)
            return gen.decode(c, z_i), c

        for gen, z_i in zip(gens, z):
            out, c = self._run(one, x, z_i, gen)
            outs.append(out)
            contents.append(c)
        outs, contents = torch.stack(outs), torch.stack(contents)
        if self.focus:
            x_t, mask = composite_with_mask(outs, x, self.mask_activation)
            return x_t, mask, contents
        return outs, None, contents

    def _w(self, name: str, base, step: int):
        """Effective loss weight at ``step`` (constant unless scheduled)."""
        sched = self.cfg.loss_schedules.get(name)
        if sched is None or sched.is_constant:
            return base
        return sched.value(step)

    # ------------------------------------------------------------------
    # per-phase losses
    # ------------------------------------------------------------------

    def _dis_loss_dir(self, dis: Sequence[MsImageDis], fakes: torch.Tensor,
                      real: torch.Tensor, step: int) -> torch.Tensor:
        loss = sum(gan_dis_loss(d_i(f_i), d_i(real), self.gan_type)
                   for d_i, f_i in zip(dis, fakes))
        # gan_w weights the discriminator objective too (MUNIT semantics)
        return self._w("gan_w", self.cfg.gan_w, step) * loss

    def _gen_loss_dir(self, gens: Sequence[AdaINGen],
                      dis: Sequence[MsImageDis], cdis: Sequence[MsImageDis],
                      x_in: torch.Tensor, z: torch.Tensor, step: int,
                      out_offset: int = 0, member_scale: float = 1.0,
                      translated=None):
        """Generator loss for the members in ``gens`` -> (total, metrics).

        ``out_offset``/``member_scale``: ``gens`` may be a contiguous slice
        of the council starting at global index ``out_offset``, with
        ``member_scale = local/total`` rescaling the mean-over-members mask
        losses so that slice sums reproduce the global loss. ``translated``:
        this slice's ``_translate_members`` output when already computed."""
        cfg, cc = self.cfg, self.cfg.council
        x_t, mask, contents = (translated if translated is not None else
                               self._translate_members(gens, x_in, z))
        m: Dict[str, torch.Tensor] = {}

        def member_adv(x_i, d_i):
            return gan_gen_loss(d_i(x_i), self.gan_type)

        loss_adv = sum(self._run(member_adv, x_i, d_i)
                       for d_i, x_i in zip(dis, x_t))
        m["loss_gen_adv"] = loss_adv
        total = self._w("gan_w", cfg.gan_w, step) * loss_adv

        if self.has_council:
            loss_c = council_gen_loss(
                cdis, x_t, x_in, self.gan_type, self.conditional,
                out_offset=out_offset, remat=cfg.remat,
                polarity=cc.council_polarity)
            gate = float(step >= cc.council_start_at_iter)
            m["loss_gen_council"] = loss_c
            total = total + self._w("council_w", cc.council_w,
                                    step) * gate * loss_c

        if self.focus:
            gate_f = float(step >= cc.focus_start_at_iter)
            ls = mask_size_loss(mask) * member_scale
            lb = mask_binary_loss(mask) * member_scale
            m["loss_gen_mask_size"] = ls
            m["loss_gen_mask_binary"] = lb
            total = total + gate_f * (
                self._w("mask_total_w", cc.mask_total_w, step) * ls
                + self._w("mask_zero_or_one_w", cc.mask_zero_or_one_w,
                          step) * lb)
            if cc.mask_tv_w:
                lt = mask_tv_loss(mask) * member_scale
                m["loss_gen_mask_tv"] = lt
                total = total + gate_f * self._w("mask_tv_w", cc.mask_tv_w,
                                                 step) * lt

        if cfg.recon_x_w:
            # reuses the translation's content codes (one fewer
            # content-encoder pass per member than the reference)
            def member_recon(c_i, gen):
                out = gen.decode(c_i, gen.encode_style(x_in))
                xr = (composite_with_mask(out, x_in, self.mask_activation)[0]
                      if self.focus else out)
                return torch.mean(torch.abs(xr.float() - x_in.float()))

            loss_rx = sum(self._run(member_recon, c_i, gen)
                          for gen, c_i in zip(gens, contents))
            m["loss_gen_recon_x"] = loss_rx
            total = total + self._w("recon_x_w", cfg.recon_x_w,
                                    step) * loss_rx

        if cfg.recon_s_w:
            s_rec = torch.stack([self._run(gen.encode_style, x_i)
                                 for gen, x_i in zip(gens, x_t)])
            # mean over (members, B, s) x local member count == the sum
            # over members of per-member means
            loss_rs = torch.mean(torch.abs(s_rec.float() - z.float())
                                 ) * x_t.shape[0]
            m["loss_gen_recon_s"] = loss_rs
            total = total + self._w("recon_s_w", cfg.recon_s_w,
                                    step) * loss_rs

        if self.vgg is not None:
            # x_in carries no gradient: its features once, not per member
            with torch.no_grad():
                target = vgg_target_features(self.vgg, x_in)
            loss_vgg = sum(compute_vgg_loss(self.vgg, x_i, x_in, target)
                           for x_i in x_t)
            m["loss_gen_vgg"] = loss_vgg
            total = total + self._w("vgg_w", cfg.vgg_w, step) * loss_vgg

        if cfg.recon_c_w:
            c_rec = torch.stack([self._run(gen.encode_content, x_i)
                                 for gen, x_i in zip(gens, x_t)])
            loss_rc = torch.mean(torch.abs(
                c_rec.float() - contents.detach().float())) * x_t.shape[0]
            m["loss_gen_recon_c"] = loss_rc
            total = total + self._w("recon_c_w", cfg.recon_c_w,
                                    step) * loss_rc
        return total, m

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _apply_if_finite(self, params: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor], tx: Adam,
                         opt: AdamState):
        """One optimizer phase, guarded by ``cfg.skip_nonfinite_updates``:
        writes the new values into ``params`` and returns (new opt state,
        ok). With the guard on and any non-finite gradient coordinate, the
        params and the optimizer state keep their values (a select on the
        device, no host sync) and ok is 0."""
        new_params, new_opt = tx.update(params, grads, opt)
        ok = torch.ones((), dtype=torch.float32, device=self.device)
        if self.cfg.skip_nonfinite_updates:
            good = self._all_ok(
                torch.stack([torch.isfinite(g).all() for g in grads]).all())

            def sel(new, old):
                return [torch.where(good, a, b) for a, b in zip(new, old)]

            new_params = sel(new_params, params)
            new_opt = AdamState(
                count=torch.where(good, new_opt.count, opt.count),
                mu=sel(new_opt.mu, opt.mu), nu=sel(new_opt.nu, opt.nu))
            ok = good.float()
        with torch.no_grad():
            for p, v in zip(params, new_params):
                p.copy_(v)
        return new_opt, ok

    def _to_device(self, a) -> torch.Tensor:
        """Host data to the device in the compute dtype, without blocking:
        a plain host-to-device copy would wait for the queued steps."""
        t = torch.as_tensor(a)
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device).to(self.dtype)

    def draw_zs(self, state: TrainState, batch: int) -> Dict[str, Any]:
        """z codes for one step from ``state.generator`` (CPU draws, so the
        stream does not depend on the device): ``{"gen", "cdis", "dis":
        {direction: (N, B, style_dim)}}``, plus ``"cdis_repeat"`` (one such
        dict per extra council-discriminator update) under
        ``cdis_ratio_mode="k_per_step"``."""
        shape = (self.n, batch, self.cfg.gen.style_dim)

        def draw(_fold):
            return torch.randn(shape, generator=state.generator)

        zs_gen, zs_cdis, zs_dis = draw_phase_zs(draw, self.directions,
                                                self.cfg.z_mode)
        zs: Dict[str, Any] = {"gen": zs_gen, "cdis": zs_cdis, "dis": zs_dis}
        ratio = self._cdis_ratio()
        if self.has_council and ratio > 1 and \
                self.cfg.council.cdis_ratio_mode == "k_per_step":
            zs["cdis_repeat"] = [{d: draw(0) for d in self.directions}
                                 for _ in range(1, ratio)]
        return zs

    def _local_zs(self, zs: Mapping[str, Any]) -> Dict[str, Any]:
        """Global z codes (:meth:`draw_zs` at the global batch) -> this
        trainer's (members, rows) block of each."""
        def block(z):
            b = z.shape[1] // self.data_size
            r0 = self.data_index * b
            return z[self.member_offset:self.member_offset + self.n_local,
                     r0:r0 + b]

        out: Dict[str, Any] = {}
        for key, streams in zs.items():
            if key == "cdis_repeat":
                out[key] = [{d: block(z) for d, z in s.items()}
                            for s in streams]
            else:
                out[key] = {d: block(z) for d, z in streams.items()}
        return out

    # -- the layout's hooks: identities on one process (parallel/) --------

    def _gather_members(self, t: torch.Tensor) -> torch.Tensor:
        """This trainer's members' (n_local, ...) stack -> all N members',
        in member order."""
        return t

    def _council_dis(self, state: TrainState, d: str) -> Sequence[Callable]:
        """All N council discriminators of direction ``d`` at their current
        parameters, for the generators' agreement term."""
        return state.cdis[d]

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """This process's gradients of one group -> the step's."""
        return grads

    def _all_ok(self, good: torch.Tensor) -> torch.Tensor:
        """This process's finite-gradient flag -> every process's."""
        return good

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """This process's step metrics -> the step's."""
        return metrics

    def _cdis_ratio(self) -> int:
        return max(1, self.cfg.council.council_dis_relative_iteration)

    def _fakes(self, state: TrainState, inputs,
               z_by_dir) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return {d: self._translate_members(
                state.gen[d], inputs[d][0],
                self._to_device(z_by_dir[d]))[0]
                for d in self.directions}

    def _cdis_update(self, state: TrainState, inputs, fakes):
        """One council-discriminator update on ``fakes`` (all N members'
        detached translations)."""
        params = group_params(state.cdis)
        loss = sum(council_dis_loss(
            state.cdis[d], fakes[d], inputs[d][0], self.gan_type,
            self.conditional, dis_offset=self.member_offset,
            n_total=self.n, remat=self.cfg.remat,
            polarity=self.cfg.council.council_polarity)
            for d in self.directions)
        state.opt_cdis, ok = self._apply_if_finite(
            params, self._reduce_grads(_grads(loss, params)), self.cdis_tx,
            state.opt_cdis)
        return loss.detach(), ok

    def train_step(self, state: TrainState, x_a, x_b,
                   zs: Optional[Mapping[str, Any]] = None):
        """One iteration: council-dis -> dis -> gen. Updates ``state`` in
        place and returns ``(state, metrics)``; the metrics are 0-d tensors
        on the device (no host sync). ``zs``: injected z codes as
        :meth:`draw_zs` returns them (numpy or tensors); only the streams
        ``cfg.z_mode`` reads are needed."""
        cfg, cc = self.cfg, self.cfg.council
        x_a, x_b = self._to_device(x_a), self._to_device(x_b)
        inputs = {"a2b": (x_a, x_b), "b2a": (x_b, x_a)}
        step = state.step
        if zs is None:
            zs = self.draw_zs(state, x_a.shape[0] * self.data_size)
        zs = self._local_zs(zs)
        zs_gen = {d: self._to_device(zs["gen"][d]) for d in self.directions}
        z_mode = cfg.z_mode
        metrics: Dict[str, torch.Tensor] = {}

        # detached fakes for the discriminator phases (see the module
        # docstring for when they are the generator phase's translations)
        translated = None
        if z_mode == "shared" and cfg.gen_member_chunks == 1:
            translated = {d: self._translate_members(
                state.gen[d], inputs[d][0], zs_gen[d])
                for d in self.directions}
            fakes = {d: translated[d][0].detach() for d in self.directions}
        else:
            fakes = self._fakes(state, inputs,
                                zs["gen"] if z_mode == "shared"
                                else zs["dis"])
        fakes_cdis = (self._fakes(state, inputs, zs["cdis"])
                      if z_mode == "per_phase" else fakes)
        fakes_cdis = {d: self._gather_members(f)
                      for d, f in fakes_cdis.items()}

        # ---- phase 1: council discriminators (reference dis_council_update)
        if self.has_council:
            ratio = self._cdis_ratio()
            if ratio == 1 or cc.cdis_ratio_mode == "k_per_step":
                loss_cdis, ok_cdis = self._cdis_update(state, inputs,
                                                       fakes_cdis)
                for it in range(1, ratio):
                    fakes_i = {d: self._gather_members(f) for d, f in
                               self._fakes(state, inputs,
                                           zs["cdis_repeat"][it - 1]).items()}
                    loss_cdis, ok_i = self._cdis_update(state, inputs,
                                                        fakes_i)
                    ok_cdis = ok_cdis * ok_i
            else:   # "every_kth": one update on steps where step % k == 0
                updated = step % ratio == 0
                if updated:
                    loss_cdis, ok_cdis = self._cdis_update(state, inputs,
                                                           fakes_cdis)
                else:
                    loss_cdis = torch.zeros((), device=self.device)
                    ok_cdis = torch.ones((), device=self.device)
                metrics["cdis_updated"] = torch.tensor(
                    float(updated), device=self.device)
            metrics["loss_dis_council"] = loss_cdis
            if cfg.skip_nonfinite_updates:
                metrics["finite_cdis"] = ok_cdis

        # ---- phase 2: domain discriminators (reference dis_update)
        params = group_params(state.dis)
        loss_dis = sum(self._dis_loss_dir(state.dis[d], fakes[d],
                                          inputs[d][1], step)
                       for d in self.directions)
        state.opt_dis, ok_dis = self._apply_if_finite(
            params, self._reduce_grads(_grads(loss_dis, params)),
            self.dis_tx, state.opt_dis)
        metrics["loss_dis_adv"] = loss_dis.detach()
        if cfg.skip_nonfinite_updates:
            metrics["finite_dis"] = ok_dis
        del fakes, fakes_cdis

        # ---- phase 3: generators (reference gen_update), seeing the freshly
        # updated discriminators
        params = group_params(state.gen)
        if cfg.gen_member_chunks > 1:
            loss_gen, aux, grads = self._gen_grads_chunked(state, inputs,
                                                           zs_gen, step)
        else:
            loss_gen, aux = 0.0, {}
            for d in self.directions:
                ld, md = self._gen_loss_dir(
                    state.gen[d], state.dis[d], self._council_dis(state, d),
                    inputs[d][0], zs_gen[d], step,
                    out_offset=self.member_offset,
                    member_scale=self.n_local / self.n,
                    translated=translated[d] if translated else None)
                loss_gen = loss_gen + ld
                aux.update({f"{k}_{d}": v.detach() for k, v in md.items()})
            grads = _grads(loss_gen, params)
            loss_gen = loss_gen.detach()
        del translated
        state.opt_gen, ok_gen = self._apply_if_finite(
            params, self._reduce_grads(grads), self.gen_tx, state.opt_gen)
        metrics["loss_gen_total"] = loss_gen
        metrics.update(aux)
        if cfg.skip_nonfinite_updates:
            metrics["finite_gen"] = ok_gen
        state.step += 1
        return state, self._reduce_metrics(metrics)

    def _gen_grads_chunked(self, state: TrainState, inputs, zs, step: int):
        """Gen-phase gradients over ``cfg.gen_member_chunks`` contiguous
        member groups, one backward per group in turn, so that at most one
        group's activations are alive. Each member's loss terms depend only
        on its own generator (the discriminators are fixed here), so the
        groups' gradients are disjoint and together equal the unchunked
        ones; ``out_offset`` keeps the council diagonal global and
        ``member_scale`` rescales the mean-over-members mask losses."""
        chunks = self.cfg.gen_member_chunks
        m = self.n_local // chunks
        cdis = {d: self._council_dis(state, d) for d in self.directions}
        loss_gen = torch.zeros((), device=self.device)
        aux: Dict[str, torch.Tensor] = {}
        grads_by_param: Dict[int, torch.Tensor] = {}
        for c in range(chunks):
            sl = slice(c * m, (c + 1) * m)
            loss = 0.0
            for d in self.directions:
                ld, md = self._gen_loss_dir(
                    state.gen[d][sl], state.dis[d][sl], cdis[d],
                    inputs[d][0], zs[d][sl], step,
                    out_offset=self.member_offset + c * m,
                    member_scale=m / self.n)
                loss = loss + ld
                for k, v in md.items():
                    key = f"{k}_{d}"
                    aux[key] = aux.get(key, 0.0) + v.detach()
            ps = [p for d in self.directions for g in state.gen[d][sl]
                  for p in g.parameters()]
            for p, g in zip(ps, _grads(loss, ps)):
                grads_by_param[id(p)] = g
            loss_gen = loss_gen + loss.detach()
        grads = [grads_by_param[id(p)] for p in group_params(state.gen)]
        return loss_gen, aux, grads

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    @torch.no_grad()
    def sample(self, state: TrainState, x, direction: str = "a2b",
               z=None):
        """Reference Council_Trainer.sample: every member's translation of
        x -> (x_t (N,B,H,W,C), mask (N,B,H,W,1) | None). ``z`` (N, B,
        style_dim) or drawn from ``state.generator``. Under member
        parallelism a collective: every process translates with its
        members, and the outputs are gathered."""
        x = self._to_device(x)
        if z is None:
            z = torch.randn((self.n, x.shape[0], self.cfg.gen.style_dim),
                            generator=state.generator)
        z = z[self.member_offset:self.member_offset + self.n_local]
        x_t, mask, _ = self._translate_members(state.gen[direction], x,
                                               self._to_device(z))
        return (self._gather_members(x_t),
                None if mask is None else self._gather_members(mask))
