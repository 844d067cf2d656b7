"""Process grids for training, device grids for serving, and the
data-parallel trainer.

Counterpart of ``councilx/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over the devices of one controller and lets GSPMD
insert the collectives. The port runs one process per GPU, so a
:class:`ProcessGrid` takes the mesh's place: the ranks of a
``torch.distributed`` world laid out as ``("data",)`` or ``("data",
"council")``, rank ``r`` at ``(r // K, r % K)`` (the order
``devices.reshape(D, K)`` gives), with one process group per row and column.

* **Data axis**: the global batch splits over ``data``; parameters and
  optimizer state are replicated along it. The step's loss is each rank's
  mean over its rows, so the mean of the ranks' gradients is the gradient
  of the global mean (JAX's ``pmean`` of the loss, differentiated):
  :class:`DataParallelTrainer` sums each parameter group's gradients in one
  flat bucket with ``all_reduce`` over ``data`` and divides by D. The
  port's step takes its gradients with ``torch.autograd.grad``, whose
  results DDP's reducer hooks never see, so no module is wrapped in
  ``DistributedDataParallel``.
* **Council axis**: members split over ``council``
  (``parallel/council_shard.py``).

Serving runs in one process over a list of devices
(``inference/translate.py``): :func:`make_member_mesh` gives its ``(D, K)``
:class:`DeviceGrid`; a list may name one card more than once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from councilx_torch.config import Config
from councilx_torch.train.trainer import CouncilTrainer


@dataclass(frozen=True)
class ProcessGrid:
    """The ranks of the world as a ``(D, K)`` grid: this rank's place and
    its two process groups, ``groups["data"]`` (the ranks of its column,
    the same council slice) and ``groups["council"]`` (the ranks of its
    row, the same data shard), each in axis order."""

    axis_names: Tuple[str, ...]
    data_size: int
    council_size: int
    data_index: int
    council_index: int
    groups: Dict[str, object]


def make_mesh(n_devices: Optional[int] = None, council_parallel: int = 1,
              always_2d: bool = False) -> ProcessGrid:
    """The grid over the world's ``n_devices`` ranks (default: all), one
    process per GPU. ``council_parallel <= 1`` -> ``("data",)``; ``k > 1``
    -> ``("data", "council")`` with a council axis of k; ``always_2d``
    keeps the council axis at k = 1 (the shard trainer's pure data
    parallelism, e.g. under ``det_data_reduction``).

    Every rank must call this, in the same order: it creates every
    process group of the grid on every rank, as ``dist.new_group``
    requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"num_devices={n} needs {n} processes, one per GPU (launch with "
            f"torchrun --nproc_per_node={n}, or --coordinator/"
            f"--num_processes/--process_id); this run has {world}")
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized process group "
                         "(parallel.multihost.maybe_init_distributed)")
    k = max(1, council_parallel)
    if n % k:
        raise ValueError(f"{n} devices not divisible by "
                         f"council_parallel={council_parallel}")
    d_size = n // k
    rank = dist.get_rank()
    data_ranks = [tuple(d * k + c for d in range(d_size)) for c in range(k)]
    council_ranks = [tuple(d * k + c for c in range(k))
                     for d in range(d_size)]
    data_groups = [dist.new_group(list(r)) for r in data_ranks]
    council_groups = [dist.new_group(list(r)) for r in council_ranks]
    d_idx, c_idx = divmod(rank, k)
    axes = (("data", "council") if council_parallel > 1 or always_2d
            else ("data",))
    return ProcessGrid(
        axis_names=axes, data_size=d_size, council_size=k, data_index=d_idx,
        council_index=c_idx,
        groups={"data": data_groups[c_idx], "council": council_groups[d_idx]})


@dataclass(frozen=True)
class DeviceGrid:
    """Devices of one serving process as a ``(D, K)`` grid: ``devices[d]
    [c]`` serves batch slice d of members slice c."""

    axis_names: Tuple[str, ...]
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {"data": len(self.devices), "council": len(self.devices[0])}
        return {a: sizes[a] for a in self.axis_names}


def local_devices(n: int, device="cuda") -> List[torch.device]:
    """The first ``n`` cards of this machine (refused where it has fewer),
    or ``n`` times the CPU for ``device="cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def make_member_mesh(n_shards: int, devices: Optional[Sequence] = None,
                     data_parallel: int = 1) -> DeviceGrid:
    """The grid of member-sharded ensemble serving
    (``inference.translate.MemberShardedTranslator``) over the first
    ``n_shards * data_parallel`` of ``devices`` (default: the machine's
    cards). ``data_parallel = 1``: ``("council",)``, the members split
    over the devices and the batch is replicated; D > 1: ``("data",
    "council")``, the batch splits too."""
    need = n_shards * data_parallel
    if devices is None:
        devices = local_devices(need)
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    rows = tuple(tuple(devices[d * n_shards:(d + 1) * n_shards])
                 for d in range(max(1, data_parallel)))
    axes = ("data", "council") if data_parallel > 1 else ("council",)
    return DeviceGrid(axis_names=axes, devices=rows)


class DataParallelTrainer(CouncilTrainer):
    """CouncilTrainer on the rows of one data shard of a ``("data",)``
    grid: every rank holds all members, the gradients of each parameter
    group are averaged over ``data`` in one flat bucket, the metrics too,
    and the skip-nonfinite gate takes the minimum over the grid.

    ``train_step(state, x_a, x_b, zs=None)`` takes this rank's rows of the
    global batch; the z codes are the global draw (every rank draws it from
    the same generator, or the caller passes it as the one-process step
    takes it) sliced to this rank's rows.

    On a card :meth:`compile_step` captures the step with its collectives
    (the counterpart of the JAX trainer's jitted step): every tensor they
    read or write is made inside the step (the flat buckets, the gathered
    parts, the flags), so inside a graph it lives in the graph's pool, and
    each group's NCCL communicator is made by the eager warm-up call, at
    its first collective, before any capture."""

    axes = ("data",)
    wrong_grid = ("DataParallelTrainer takes a 1-D ('data',) grid; for a "
                  "('data','council') grid use councilx_torch.parallel."
                  "council_shard.CouncilShardTrainer")

    def __init__(self, cfg: Config, mesh: ProcessGrid, device="cuda"):
        if tuple(mesh.axis_names) != self.axes:
            raise ValueError(self.wrong_grid)
        super().__init__(cfg, device=device)
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise ValueError(f"a {self.device.type} trainer needs a {want} "
                             f"process group, this one is "
                             f"{dist.get_backend()}")
        self.mesh = mesh
        self.data_index, self.data_size = mesh.data_index, mesh.data_size

    def layout(self) -> str:
        return (f"{type(self).__name__} at (data {self.mesh.data_index}, "
                f"council {self.mesh.council_index}) of a D="
                f"{self.mesh.data_size} x K={self.mesh.council_size} grid, "
                f"rank {dist.get_rank()} of {dist.get_world_size()} "
                f"({dist.get_backend()})")

    def _agree_on_capture(self, key: tuple) -> None:
        """Every rank captures the same step graph at the same step, or
        their captured collectives would pair with the wrong ones: the step
        key gathered over the world (eagerly, before the capture) must be
        the same on every rank."""
        code = torch.tensor([int(v) for part in key for v in
                             (part if isinstance(part, tuple) else (part,))],
                            dtype=torch.int64, device=self.device)
        parts = [torch.empty_like(code) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, code)
        keys = [tuple(p.tolist()) for p in parts]
        if len(set(keys)) > 1:
            raise RuntimeError(f"{self.layout()}: the ranks would capture "
                               f"different step graphs, keys {keys}")

    def _mean_data(self, flat: torch.Tensor) -> torch.Tensor:
        """Mean of ``flat`` over the data axis, in place."""
        dist.all_reduce(flat, group=self.mesh.groups["data"])
        return flat.div_(self.data_size)

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        flat = self._mean_data(torch.cat([g.reshape(-1) for g in grads]))
        return [t.view_as(g) for t, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def _all_ok(self, good: torch.Tensor) -> torch.Tensor:
        flag = good.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return flag.bool()

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Loss metrics: the mean over ``data``, then (member-sharded) the
        sum over ``council``; the finite flags and the cdis gate are
        already the same everywhere."""
        keys = [k for k in metrics
                if not k.startswith("finite_") and k != "cdis_updated"]
        if not keys:
            return metrics
        vals = self._mean_data(torch.stack(
            [metrics[k].float().reshape(()) for k in keys]))
        vals = self._sum_council(vals)
        return {**metrics, **dict(zip(keys, vals.unbind()))}

    def _sum_council(self, vals: torch.Tensor) -> torch.Tensor:
        return vals

    def snapshot(self, state) -> Optional[dict]:
        """Rank 0's copy of the state (every replica is the same), None
        elsewhere."""
        return state.snapshot() if dist.get_rank() == 0 else None
