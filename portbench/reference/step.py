"""Council-GAN's train step and serving forward in plain PyTorch.

One step, in the order of Council-GAN's ``trainer_council.py``: the council
discriminators (``dis_council_update``), then the domain discriminators
(``dis_update``), then the generators (``gen_update``), which see both
freshly updated. a2b only. The losses, for a council of N members with
translations ``x_t[i] = G_i(x_a, z_i)``:

* council discriminator j, on the pairs ``(x_t[i] || x_a)``: per scale
  ``mean((D^_j(pair_j) - 1)^2) + sum_{i != j} mean(D^_j(pair_i)^2) / (N-1)``
  (its own member's pairs are its real class);
* discriminator i: ``gan_w * sum over scales of mean(D_i(x_t[i])^2) +
  mean((D_i(x_b) - 1)^2)`` (LSGAN);
* generator i: ``gan_w * sum_s mean((D_i(x_t[i]) - 1)^2)``, plus
  ``council_w * sum_{j != i} sum_s mean((D^_j(pair_i) - 1)^2)`` from the
  council's start iteration on, plus with the focus mask
  ``mask_total_w * mean(mask_i) / N + mask_zero_or_one_w * mean(mask_i *
  (1 - mask_i)) / N`` from the focus start on, plus ``recon_x_w *
  mean|G_i.decode(c_i, E^s_i(x_a)) (composited) - x_a|`` (``c_i`` the
  translation's content code), ``recon_s_w * mean|E^s_i(x_t[i]) - z_i|`` and
  ``recon_c_w * mean|E^c_i(x_t[i]) - c_i|`` (``c_i`` held constant).

Each group steps by Adam with L2 weight decay added to the gradient, eps
outside the square root, bias-corrected moments and ``lr * gamma ** (count //
step_size)``. The discriminator phases take the translations detached.

Every member's terms depend on its own generator (the discriminators held)
and every discriminator's on its own weights, so each is differentiated by
itself: the step holds one member's activations at a time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch

from portbench.reference.model import (AdaINGen, MsImageDis, Round, from_u8,
                                       to_u8)

GROUPS = ("gen", "dis", "cdis")


def council_keys(cfg: dict) -> dict:
    """The settings the step reads from a configuration's ``config`` dict
    (Council-GAN's YAML keys; focus under ``focus_loss``)."""
    c, f = cfg.get("council", {}), cfg.get("focus_loss", {})
    return {"n": c["council_size"], "council_w": c["council_w"],
            "council_start": c.get("council_start_at_iter", 0),
            "focus": bool(f.get("focus_enabled", False)),
            "mask_total_w": f.get("mask_total_w", 0.0),
            "mask_zero_or_one_w": f.get("mask_zero_or_one_w", 0.0),
            "focus_start": f.get("focus_start_at_iter", 0)}


def build(cfg: dict, group: str, q: Round = None, device="cpu"):
    """One member of ``group`` ("gen", "dis", "cdis")."""
    if group == "gen":
        m = AdaINGen(cfg["gen"], council_keys(cfg)["focus"], q)
    else:
        m = MsImageDis(cfg["dis"], 6 if group == "cdis" else 3, q)
    return m.to(device)


def lsgan(outs, target: float) -> torch.Tensor:
    return sum(torch.mean((o - target) ** 2) for o in outs)


def pairs(x_t: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """(x_t || x_in) on the channel axis, NHWC."""
    return torch.cat([x_t, x_in], dim=-1)


@dataclass
class Adam:
    """One group's Adam state: per parameter name, the two moments."""

    lr: float
    b1: float
    b2: float
    wd: float
    step_size: int
    gamma: float
    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr * self.gamma ** (self.count // self.step_size)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k] + self.wd * p
            mu = self.mu.get(k, torch.zeros_like(p)) * self.b1 \
                + (1 - self.b1) * g
            nu = self.nu.get(k, torch.zeros_like(p)) * self.b2 \
                + (1 - self.b2) * g * g
            self.mu[k], self.nu[k] = mu, nu
            p -= lr * (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)


class Council:
    """The N members of each group, their Adam states, and the step."""

    def __init__(self, cfg: dict, state: Dict[str, List[Dict[str,
                                                            torch.Tensor]]],
                 q: Round = None, device="cpu"):
        self.cfg, self.k = cfg, council_keys(cfg)
        self.n = self.k["n"]
        self.members = {grp: [build(cfg, grp, q, device)
                              for _ in range(self.n)] for grp in GROUPS}
        for grp in GROUPS:
            for m, sd in zip(self.members[grp], state[grp]):
                m.load_state_dict(sd, strict=True)
        lr_step = cfg.get("lr_policy", "step") == "step"
        self.opt = {grp: Adam(cfg["lr"], cfg["beta1"], cfg["beta2"],
                              cfg["weight_decay"],
                              cfg["step_size"] if lr_step else 1,
                              cfg["gamma"] if lr_step else 1.0)
                    for grp in GROUPS}
        self.step_no = 0

    def params(self, grp: str) -> Dict[str, torch.Tensor]:
        """``{"<member>.<name>": parameter}`` of one group."""
        return {f"{i}.{k}": p for i, m in enumerate(self.members[grp])
                for k, p in m.named_parameters()}

    def _grads(self, grp: str, losses):
        """Each member's loss (a function of member i, called in turn)
        differentiated by its own parameters -> (gradients by
        ``"<member>.<name>"``, the summed loss)."""
        out, total = {}, 0.0
        for i, m in enumerate(self.members[grp]):
            loss = losses(i)
            names = [k for k, _ in m.named_parameters()]
            gs = torch.autograd.grad(loss, list(m.parameters()),
                                     allow_unused=True)
            for k, g, p in zip(names, gs, m.parameters()):
                out[f"{i}.{k}"] = torch.zeros_like(p) if g is None else g
            total = total + loss.detach()
        return out, total

    def step(self, x_a: torch.Tensor, x_b: torch.Tensor,
             z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One iteration on a batch (x_a, x_b NHWC in [-1, 1]) and the
        members' style codes z (N, B, style_dim) -> the step's losses (0-d
        tensors) and, under ``"grads"``, every group's gradients."""
        k, cfg, n = self.k, self.cfg, self.n
        gens, dis, cdis = (self.members[g] for g in GROUPS)
        with torch.no_grad():
            fakes = [g.translate(x_a, z_i)[0] for g, z_i in zip(gens, z)]
        metrics, grads = {}, {}

        def cdis_loss(j):
            loss = 0.0
            for i in range(n):
                outs = cdis[j](pairs(fakes[i], x_a))
                loss = loss + (lsgan(outs, 1.0) if i == j
                               else lsgan(outs, 0.0) / (n - 1))
            return loss

        grads["cdis"], metrics["loss_dis_council"] = self._grads(
            "cdis", cdis_loss)
        self.opt["cdis"].update(self.params("cdis"), grads["cdis"])

        def dis_loss(i):
            return cfg["gan_w"] * (lsgan(dis[i](fakes[i]), 0.0)
                                   + lsgan(dis[i](x_b), 1.0))

        grads["dis"], metrics["loss_dis_adv"] = self._grads("dis", dis_loss)
        self.opt["dis"].update(self.params("dis"), grads["dis"])
        del fakes

        terms: Dict[str, torch.Tensor] = {}

        def add(name, value):
            terms[name] = terms.get(name, 0.0) + value.detach()
            return value

        council_on = float(self.step_no >= k["council_start"])
        focus_on = float(self.step_no >= k["focus_start"])

        def gen_loss(i):
            g, z_i = gens[i], z[i]
            x_t, mask, c = g.translate(x_a, z_i)
            total = cfg["gan_w"] * add("loss_gen_adv",
                                       lsgan(dis[i](x_t), 1.0))
            if n > 1 and k["council_w"] > 0:
                pair = pairs(x_t, x_a)
                lc = sum(lsgan(cdis[j](pair), 1.0)
                         for j in range(n) if j != i)
                total = total + k["council_w"] * council_on * add(
                    "loss_gen_council", lc)
            if k["focus"]:
                m = mask
                total = total + focus_on * (
                    k["mask_total_w"] * add("loss_gen_mask_size",
                                            m.mean() / n)
                    + k["mask_zero_or_one_w"] * add(
                        "loss_gen_mask_binary", (m * (1 - m)).mean() / n))
            if cfg["recon_x_w"]:
                xr = g.composite(g.decode(c, g.encode_style(x_a)), x_a)[0]
                total = total + cfg["recon_x_w"] * add(
                    "loss_gen_recon_x", (xr - x_a).abs().mean())
            if cfg["recon_s_w"]:
                total = total + cfg["recon_s_w"] * add(
                    "loss_gen_recon_s", (g.encode_style(x_t) - z_i).abs()
                    .mean())
            if cfg["recon_c_w"]:
                total = total + cfg["recon_c_w"] * add(
                    "loss_gen_recon_c", (g.encode_content(x_t)
                                         - c.detach()).abs().mean())
            return total

        grads["gen"], metrics["loss_gen_total"] = self._grads("gen",
                                                              gen_loss)
        self.opt["gen"].update(self.params("gen"), grads["gen"])
        metrics.update({f"{name}_a2b": v for name, v in terms.items()})
        self.step_no += 1
        metrics["grads"] = grads
        return metrics


@torch.no_grad()
def serve_u8(gens: List[AdaINGen], x_u8: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """The serving forward: uint8 images (B, H, W, 3) and one style code
    per image (B, style_dim) -> every member's uint8 translation (N, B, H,
    W, 3), each member under the same z."""
    x = from_u8(x_u8)
    return torch.stack([to_u8(g.translate(x, z)[0]) for g in gens])
