"""Config-gated loss-weight schedules: warmup + annealing.

Counterpart of ``councilx/schedules.py``. Every loss weight (``gan_w``,
``recon_*_w``, ``vgg_w``, ``council_w``, ``mask_*_w``) may be written in
YAML either as a scalar (constant, the default) or as a dict::

    council_w: {base: 0.2, start_at_iter: 10000, warmup_iters: 5000}
    mask_total_w:
      base: 0.005
      anneal: cosine          # none | linear | cosine | step
      anneal_start_iter: 50000
      anneal_iters: 100000
      end_value: 0.001

Semantics (piecewise in the training step):

  * 0 before ``start_at_iter``; linear ramp 0 -> base over ``warmup_iters``.
  * from ``anneal_start_iter`` the plateau anneals base -> ``end_value``
    over ``anneal_iters`` (linear or half-cosine), or decays by
    ``anneal_gamma`` every ``anneal_step_size`` iters (step).

:meth:`WeightSchedule.value` takes the step as a Python int (a float
evaluated on the host) or as a 0-d tensor: then it is evaluated on the
tensor's device in float32, as the JAX package evaluates it on the traced
step, so that a captured train step (``train/trainer.py``) reads the step
it replays, not the one it was captured at.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Union

import torch

_ANNEALS = ("none", "linear", "cosine", "step")


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


@dataclass(frozen=True)
class WeightSchedule:
    """A scalar loss weight as a function of the training step."""

    base: float
    start_at_iter: int = 0
    warmup_iters: int = 0
    anneal: str = "none"
    anneal_start_iter: int = 0
    anneal_iters: int = 0
    end_value: float = 0.0
    anneal_step_size: int = 0
    anneal_gamma: float = 1.0

    def __post_init__(self):
        if self.anneal not in _ANNEALS:
            raise ValueError(f"unsupported anneal: {self.anneal!r} "
                             f"(choose from {_ANNEALS})")
        if self.warmup_iters < 0 or self.start_at_iter < 0:
            raise ValueError("start_at_iter/warmup_iters must be >= 0")
        if self.anneal in ("linear", "cosine") and self.anneal_iters <= 0:
            raise ValueError(f"anneal={self.anneal} requires anneal_iters > 0")
        if self.anneal == "step" and self.anneal_step_size <= 0:
            raise ValueError("anneal=step requires anneal_step_size > 0")

    @property
    def is_constant(self) -> bool:
        return (self.start_at_iter == 0 and self.warmup_iters == 0
                and self.anneal == "none")

    def value(self, step: Union[int, torch.Tensor]
              ) -> Union[float, torch.Tensor]:
        """Weight at ``step``: a float for an int step; a 0-d float32
        tensor on the step's device for a 0-d tensor step. Constant weights
        stay the float ``base``, as in the JAX package."""
        if self.is_constant:
            return self.base
        if isinstance(step, torch.Tensor):
            return self._value_f32(step)
        s = float(step)

        # plateau value after annealing
        v = float(self.base)
        if self.anneal in ("linear", "cosine"):
            t = _clip01((s - self.anneal_start_iter) / self.anneal_iters)
            if self.anneal == "cosine":
                t = 0.5 * (1.0 - math.cos(math.pi * t))
            v = self.base + (self.end_value - self.base) * t
        elif self.anneal == "step":
            k = math.floor(max(s - self.anneal_start_iter, 0.0)
                           / self.anneal_step_size)
            v = self.base * self.anneal_gamma ** k

        # start gate / warmup ramp
        if self.warmup_iters > 0:
            ramp = _clip01((s - self.start_at_iter) / self.warmup_iters)
        else:
            ramp = 1.0 if s >= self.start_at_iter else 0.0
        return v * ramp

    def _value_f32(self, step: torch.Tensor) -> torch.Tensor:
        """:meth:`value` in float32 torch ops, op for op as
        ``councilx/schedules.py`` on a traced step. A division by an
        iteration count is a multiply by its float32 reciprocal, as XLA
        compiles it (and as PyTorch on CUDA divides by a Python number)."""
        s = step.to(torch.float32)
        if self.anneal in ("linear", "cosine"):
            t = ((s - self.anneal_start_iter)
                 * (1.0 / self.anneal_iters)).clamp(0.0, 1.0)
            if self.anneal == "cosine":
                t = 0.5 * (1.0 - torch.cos(math.pi * t))
            v = self.base + (self.end_value - self.base) * t
        elif self.anneal == "step":
            k = torch.floor((s - self.anneal_start_iter).clamp(min=0.0)
                            * (1.0 / self.anneal_step_size))
            v = self.base * torch.pow(self.anneal_gamma, k)
        else:
            v = torch.full_like(s, self.base)
        if self.warmup_iters > 0:
            ramp = ((s - self.start_at_iter)
                    * (1.0 / self.warmup_iters)).clamp(0.0, 1.0)
        else:
            ramp = (s >= self.start_at_iter).to(torch.float32)
        return v * ramp

    @classmethod
    def from_value(cls, v: Any) -> "WeightSchedule":
        """Build from a YAML value: scalar -> constant, dict -> schedule."""
        if isinstance(v, WeightSchedule):
            return v
        if isinstance(v, (int, float)):
            return cls(base=float(v))
        if isinstance(v, dict):
            d = dict(v)
            if "value" in d and "base" not in d:
                d["base"] = d.pop("value")
            if "base" not in d:
                raise ValueError(f"weight schedule dict needs 'base': {v}")
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(d) - known
            if unknown:
                raise ValueError(f"unknown weight-schedule keys: "
                                 f"{sorted(unknown)}")
            d["base"] = float(d["base"])
            return cls(**d)
        raise TypeError(f"weight must be a number or a schedule dict, "
                        f"got {type(v).__name__}")

    def to_value(self) -> Any:
        """Inverse of :meth:`from_value` (for config round-trips)."""
        if self.is_constant:
            return self.base
        return dataclasses.asdict(self)


def extract_schedules(raw: Dict[str, Any],
                      alias_map: Dict[str, tuple]) -> Dict[str, WeightSchedule]:
    """Pull dict-valued weight keys out of a raw config dict (in place).

    For every canonical weight name in ``alias_map`` whose value (under any
    alias, at the top level or inside the ``council`` / ``focus_loss``
    sub-dicts) is a dict, parse it into a :class:`WeightSchedule`, replace
    the raw value with the scalar ``base`` (so the typed config fields keep
    working, including zero-weight term pruning), and return the schedules
    keyed by canonical name.
    """
    out: Dict[str, WeightSchedule] = {}
    scopes = [raw]
    for sub in ("council", "focus_loss"):
        if isinstance(raw.get(sub), dict):
            raw[sub] = dict(raw[sub])
            scopes.append(raw[sub])
    for canon, aliases in alias_map.items():
        for scope in scopes:
            for name in aliases:
                v = scope.get(name)
                if isinstance(v, dict):
                    sched = WeightSchedule.from_value(v)
                    scope[name] = sched.base
                    if not sched.is_constant:
                        out[canon] = sched
    return out
