"""Member (council) parallelism: the members split over the ``council``
axis of a ``("data", "council")`` process grid.

Counterpart of ``councilx/parallel/council_shard.py``, which writes it with
``shard_map`` and explicit collectives; here each process runs the port's
own step (``train/trainer.py``) on its slice -- ``m = N / K`` members from
``off = c * m``, ``c`` its place on the council axis -- and the step's hooks
carry the collectives:

* every member's losses depend only on its own parameters, so each rank's
  gradients for its members are the global ones (after the mean over
  ``data``);
* two collectives couple the members: an ``all_gather`` over ``council`` of
  the detached fakes for the council-discriminator update (each D^_i sees
  every member's output, the diagonal on global indices:
  ``dis_offset=off, n_total=N``), and an ``all_gather`` of the freshly
  updated council-discriminator parameters for the generators' agreement
  term (member i is scored by every other member's D^_j:
  ``out_offset=off, member_scale=m/N``);
* the gradients are averaged over ``data`` (``det_data_reduction``:
  :func:`det_pmean`'s fixed order), the loss metrics averaged over ``data``
  and summed over ``council``.

The z codes are the global draw (N, B_global, style_dim), sliced to the
rank's (members, rows) block, so the step is the one-process step at the
same global batch; at D = 1 each member's parameters and Adam moments are
bit for bit the one-process step's. On a card the step is captured with
these collectives (``compile_step``, as in ``parallel/mesh.py``): the
shadow council discriminators that take the gathered parameters are built
by the eager warm-up call, so a captured step only copies into them.
:meth:`CouncilShardTrainer.snapshot`
gathers the members to rank 0 in the one-process layout, so a snapshot
resumes under any layout.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from councilx_torch.config import Config
from councilx_torch.parallel.mesh import DataParallelTrainer, ProcessGrid
from councilx_torch.train.trainer import GROUPS, TrainState


def det_pmean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Mean of ``x`` over ``group`` (``size`` ranks) in a fixed order: an
    all-gather (data movement only), then a sum in rank order. The result
    does not depend on the collective's algorithm or the process layout."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s / size


class CouncilShardTrainer(DataParallelTrainer):
    """CouncilTrainer with the members split over the grid's ``council``
    axis and the batch over its ``data`` axis."""

    axes = ("data", "council")
    wrong_grid = ("CouncilShardTrainer needs a ('data','council') grid "
                  "(parallel.mesh.make_mesh(council_parallel=k))")

    def __init__(self, cfg: Config, mesh: ProcessGrid, device="cuda"):
        super().__init__(cfg, mesh, device=device)
        self.k = mesh.council_size
        if self.n % self.k:
            raise ValueError(f"council_size {self.n} not divisible by "
                             f"council axis {self.k}")
        self.n_local = self.n // self.k
        self.member_offset = mesh.council_index * self.n_local
        if self.n_local % cfg.gen_member_chunks:
            raise ValueError(f"gen_member_chunks {cfg.gen_member_chunks} "
                             f"must divide the {self.n_local} members of "
                             "each council shard")
        self.det_reduce = bool(cfg.det_data_reduction)
        # the other shards' council discriminators, by direction: modules
        # that take the gathered parameters each step (no gradients)
        self._shadows: Dict[str, List] = {}

    def _council_group(self):
        return self.mesh.groups["council"]

    def _mean_data(self, flat: torch.Tensor) -> torch.Tensor:
        if not self.det_reduce:
            return super()._mean_data(flat)
        return det_pmean(flat, self.mesh.groups["data"], self.data_size)

    def _sum_council(self, vals: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(vals, group=self._council_group())
        return vals

    def _gather_flat(self, tensors: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """One flat buffer of ``tensors`` (the same shapes and dtype on
        every shard) from each council shard, in council order."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        parts = [torch.empty_like(flat) for _ in range(self.k)]
        dist.all_gather(parts, flat, group=self._council_group())
        return parts

    def _gather_members(self, t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.k)]
        dist.all_gather(parts, t.contiguous(), group=self._council_group())
        return torch.cat(parts)

    def _council_dis(self, state: TrainState, d: str) -> Sequence[Callable]:
        local = state.cdis[d]
        parts = self._gather_flat([p for m in local for p in m.parameters()])
        shadows = self._shadows.get(d)
        if shadows is None:
            shadows = self._shadows[d] = [
                self._make_member("cdis").requires_grad_(False)
                for _ in range(self.n - self.n_local)]
        mods, it = [], iter(shadows)
        with torch.no_grad():
            for c, flat in enumerate(parts):
                if c == self.mesh.council_index:
                    mods.extend(local)
                    continue
                o = 0
                for _ in range(self.n_local):
                    mod = next(it)
                    for p in mod.parameters():
                        p.copy_(flat[o:o + p.numel()].view_as(p))
                        o += p.numel()
                    mods.append(mod)
        return mods

    def snapshot(self, state: TrainState) -> Optional[dict]:
        """The state gathered to rank 0 in the one-process layout (every
        member's parameters, buffers and Adam moments in global member
        order, on the CPU), None on every other rank. A collective of the
        council shards of data row 0, eager between compiled steps on the
        communicator the captured gathers use; the other rows hold replicas
        of the same members."""
        if self.mesh.data_index != 0:
            return None
        primary = dist.get_rank() == 0

        def gather(tensors: Sequence[torch.Tensor]) -> list:
            """Every shard's ``tensors``, in council order, on rank 0."""
            parts = self._gather_flat(tensors)
            if not primary:
                return []
            out = []
            for flat in parts:
                flat, o = flat.cpu(), 0
                for t in tensors:
                    out.append(flat[o:o + t.numel()].view_as(t).clone())
                    o += t.numel()
            return out

        params: Dict[str, Dict[str, list]] = {}
        for d in self.directions:
            params[d] = {}
            for grp in GROUPS:
                mods = getattr(state, grp)[d]
                keys = list(mods[0].state_dict())
                flat = gather([v for m in mods
                               for v in m.state_dict().values()])
                params[d][grp] = [dict(zip(keys, flat[i:i + len(keys)]))
                                  for i in range(0, len(flat), len(keys))]
        opt = {}
        for grp in GROUPS:
            per_dir = sum(len(list(m.parameters()))
                          for m in getattr(state, grp)[self.directions[0]])
            adam = getattr(state, f"opt_{grp}")
            opt[grp] = {"count": adam.count.detach().to("cpu", copy=True)}
            for key in ("mu", "nu"):
                ts = getattr(adam, key)
                opt[grp][key] = [
                    t for di in range(len(self.directions))
                    for t in gather(ts[di * per_dir:(di + 1) * per_dir])]
        if not primary:
            return None
        return {"step": int(state.step), "params": params, "opt": opt,
                "generator": state.generator.get_state()}
