"""The numbers that decide ``correct``: the program's readings against the
reference's.

Training, per cell, over two stretches of the one object the window
drives. The first three steps of set-up, from the seeded weights, check the
start; one step taken inside the window, from the program's own state just
before it (parameters, both Adam moments and the count), checks the graph
route as the window replays it. For each stretch:

* ``loss<s>_gap``: the widest relative gap of any loss the (first) step
  reports, ``|program - reference| / |reference|``;
* ``grad<s>_gap``: the step's gradient of every leaf, as the optimizer got
  it (the program's worked out from its first Adam moment before and after
  the step: ``(mu' - beta1 mu) / (1 - beta1) - weight_decay * p``),
  compared by norm: the gap between the two norms over the reference's norm
  of that leaf or of the median leaf, whichever is larger;
* ``change<s>_gap``: each leaf's change over the stretch, the same way,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (a bias ahead of an instance norm: its gradient is nought
  but for rounding, and Adam moves it by rounding alone).

``<s>`` is ``1`` (the first step's loss and gradient) and ``3`` (the change
over three steps) for the start, ``w`` for the window's step. A gap is
taken at the median leaf of each group (generators, discriminators,
council discriminators) and the worst group's is the number, so that a
group left unstepped or stepped wrong reads whatever the others do. The
median leaf, not the worst: the worst leaf is a style encoder's, whose
gradient comes through the L1 style reconstruction, ``sign(E(x_t) - z)``,
which rounding flips on residuals near nought (``PERF.md``, section 2).

Serving, per cell, over a sample of the answers served in the window:
``worst_share_off3``, the widest share of an answer's uint8 values that lie
more than 3 levels from the reference's translation of the same image
under the same style code (every member's, for the council).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping

import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def norm_gaps(prog: Mapping[str, torch.Tensor],
              ref: Mapping[str, torch.Tensor], keep=None) -> Dict[str, float]:
    """Per leaf of ``ref`` (those ``keep`` admits): ``|‖prog‖ - ‖ref‖| /
    max(‖ref‖, median leaf ‖ref‖)``; a non-finite one reads infinite."""
    keys = [k for k in ref if keep is None or keep(k)]
    rn = {k: _norm(ref[k]) for k in keys}
    med = statistics.median(rn.values())
    gaps = {}
    for k in keys:
        gap = abs(_norm(prog[k]) - rn[k]) / max(rn[k], med)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst_group_median(gaps: Mapping[str, float]) -> float:
    """The median of each group's leaves (``<group>.<member>.<name>``), and
    of those the largest."""
    groups: Dict[str, List[float]] = {}
    for k, v in gaps.items():
        groups.setdefault(k.split(".")[0], []).append(v)
    return max(statistics.median(v) for v in groups.values())


def loss_gap(prog: Mapping[str, float], ref: Mapping[str, float]) -> float:
    """Worst relative gap of any loss; a loss the program does not report,
    or reports non-finite, reads infinite."""
    worst = 0.0
    for k, rv in ref.items():
        gap = abs(prog.get(k, math.nan) - rv) / max(abs(rv), 1e-12)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def update_checks(p, mu, prog_mu, prog_p, prog_loss, ref_grads, ref_p,
                  ref_loss, beta1: float, wd: float,
                  names) -> Dict[str, float]:
    """The three numbers of one stretch of steps, from the state before it:
    parameters ``p`` and first moments ``mu`` (None: all nought); the
    program's first moments after the stretch's first step (``prog_mu``),
    its parameters after the stretch (``prog_p``) and its first step's
    losses; the reference's gradients of that first step, parameters after
    the stretch and losses. Tensors by leaf ``<group>.<member>.<name>``;
    ``names``: the loss's, the gradient's and the change's number."""
    prog_g = {k: (m.double() - (0 if mu is None else beta1 * mu[k].double()))
              / (1 - beta1) - wd * p[k].double()
              for k, m in prog_mu.items()}
    ref_norms = {k: _norm(g) for k, g in ref_grads.items()}
    floor = 1e-3 * statistics.median(ref_norms.values())
    moved = {k for k, v in ref_norms.items() if v >= floor}
    change = norm_gaps(
        {k: prog_p[k].double() - p[k].double() for k in prog_p},
        {k: ref_p[k].double() - p[k].double() for k in ref_p},
        keep=lambda k: k in moved)
    grad = worst_group_median(norm_gaps(prog_g, ref_grads))
    return dict(zip(names, (loss_gap(prog_loss, ref_loss), grad,
                            worst_group_median(change))))


def answer_gaps(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """One answer (uint8, any shape) against the reference's."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().float()
    return {"worst_share_off3": float((diff > 3).float().mean())}


def worst(readings: List[Mapping[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
