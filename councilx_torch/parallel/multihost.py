"""Process-group set-up and host helpers for multi-process training.

Counterpart of ``councilx/parallel/multihost.py``. The JAX package runs one
controller per host over ``jax.distributed``; the port runs one process per
GPU over ``torch.distributed``, the PyTorch idiom:

* :func:`maybe_init_distributed` joins the process group when the
  arguments or the environment name more than one process (the JAX
  package's ``COUNCILX_*`` variables, or torchrun's ``MASTER_ADDR``/
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``), and is a
  no-op at one process. It returns the rank's device: ``cuda:LOCAL_RANK``,
  or the CPU only when asked for. The backend follows the device: NCCL for
  CUDA, gloo for the CPU;
* :func:`is_primary` gates the host's side effects (logging, sample
  sheets, snapshot writes) to rank 0;
* :func:`broadcast_host` and :func:`allgather_int` move the few host
  values the train loop must agree on: the display batches and the resume
  step.
"""

from __future__ import annotations

import gc
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def maybe_init_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> torch.device:
    """Join the process group of a multi-process run; -> this rank's device.

    Arguments fall back to ``COUNCILX_COORDINATOR`` / ``COUNCILX_NUM_
    PROCESSES`` / ``COUNCILX_PROCESS_ID``, then to torchrun's ``WORLD_SIZE``
    and ``RANK`` (rendezvous ``env://``, from ``MASTER_ADDR`` and
    ``MASTER_PORT``). ``coordinator`` is ``host:port`` of rank 0 (a TCP
    rendezvous) or a URL such as ``file:///shared/path``. At one process
    nothing is initialized and ``device`` comes back as it was given.
    Otherwise ``device``: "cuda" (default) becomes
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK``, else the rank modulo the cards
    this host has) and is made the current device; "cpu" runs the rank on
    the CPU over gloo."""
    device = torch.device(device)
    coordinator = coordinator or os.environ.get("COUNCILX_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("COUNCILX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("COUNCILX_PROCESS_ID", "RANK")
    if dist.is_initialized():
        return _rank_device(device, dist.get_rank())
    if coordinator and num_processes is None:
        raise ValueError("--coordinator needs the process count "
                         "(--num_processes or COUNCILX_NUM_PROCESSES)")
    if not num_processes or num_processes <= 1:
        return device
    if process_id is None:
        raise ValueError(f"{num_processes} processes but no process id "
                         "(--process_id, COUNCILX_PROCESS_ID or RANK)")
    if not coordinator and "MASTER_ADDR" not in os.environ:
        raise ValueError(f"{num_processes} processes but no rendezvous "
                         "(--coordinator, COUNCILX_COORDINATOR, or torchrun's "
                         "MASTER_ADDR/MASTER_PORT)")
    if coordinator:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    else:
        init = "env://"
    device = _rank_device(device, process_id)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id)
    return device


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    if device.index is None:
        local = _env_int("LOCAL_RANK")
        if local is None:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError("no CUDA device: pass device='cpu' to "
                                   "run on the CPU")
            local = rank % count
        device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side side effects."""
    return process_index() == 0


def local_batch_size(global_batch: int, data_size: int) -> int:
    """The rows of the global batch that each data shard loads (the ranks
    of one shard, one per council slice, load the same rows)."""
    if global_batch % data_size:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"data-axis size {data_size}")
    return global_batch // data_size


def _comm_device() -> torch.device:
    """Where this process's tensors for a collective live: its current
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_host(arr: np.ndarray) -> np.ndarray:
    """Rank 0's ``arr`` on every rank (every rank passes an array of the
    same shape and dtype); ``arr`` itself at one process."""
    if process_count() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def allgather_int(value: int) -> List[int]:
    """Every rank's ``value``, in rank order."""
    if process_count() == 1:
        return [int(value)]
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [int(v) for v in torch.cat(out).cpu().tolist()]


def shutdown() -> None:
    """Leave the process group, if this process joined one. Destroying an
    NCCL communicator waits until every CUDA graph that captured one of
    its collectives is freed (a compiled step's), so unreachable ones are
    collected first."""
    if dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()
