"""Checkpoints: the port's training snapshots, generator ``.npz`` exports
and reference ``.pt`` for serving, and JAX-package training parameters for
the trainer.

Counterpart of ``councilx/ckpt/manager.py``. Training snapshots
(:func:`save_checkpoint`) go under ``checkpoints/step_%08d/`` as the JAX
package's do, but in the port's own format: one ``state.pt``, a
``torch.save`` that ``torch.load(weights_only=True)`` reads, of

    {"step": int,
     "params": {direction: {"gen" | "dis" | "cdis": [N MUNIT-layout
                                                      state dicts]}},
     "opt": {"gen" | "dis" | "cdis": {"count": 0-d int32,
                                      "mu": [...], "nu": [...]}},
     "generator": the z generator's get_state() (uint8)}

as ``train.trainer.TrainState.snapshot`` makes it and
``CouncilTrainer.restore_state`` reads it back. Snapshots are written to a
temporary directory and renamed, so a reader never sees half of one; the
newest ``keep`` are kept. The step lives in the payload and the name.

Every format becomes N per-member MUNIT-layout state dicts of float32
tensors for serving (:func:`load_generator_state_dicts`), which the port's
``AdaINGen`` loads with ``load_state_dict(strict=True)``. The JAX
package's orbax snapshots need JAX to read; export them to ``.npz`` first.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from councilx_torch.ckpt.torch_convert import extract_member_state_dicts
from councilx_torch.ckpt.torch_export import (export_adain_gen,
                                            export_ms_image_dis,
                                            unstack_members)

StateDict = Dict[str, torch.Tensor]


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    """A nested dict of arrays -> a flat ``/``-keyed ``.npz``, as
    ``councilx.ckpt.manager.save_params_npz`` writes it."""
    np.savez(path, **_flatten(params))


def load_params_npz(path: str) -> Dict[str, Any]:
    """A flat ``/``-keyed ``.npz`` (``councilx.ckpt.manager.save_params_npz``)
    -> the nested dict of numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _to_torch(sd) -> StateDict:
    return {k: (v.detach().float() if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v), dtype=torch.float32))
            for k, v in sd.items()}


def params_to_state_dicts(params, cfg) -> List[StateDict]:
    """A JAX-package generator tree, one member or stacked (N, ...) -> N
    MUNIT-layout state dicts."""
    g = cfg.gen
    first_kernel = params["enc_content"]["Conv2dBlock_0"]["Conv_0"]["kernel"]
    trees = (unstack_members(params) if np.ndim(first_kernel) == 5
             else [params])
    return [_to_torch(export_adain_gen(
        t, n_downsample=g.n_downsample, n_res=g.n_res,
        mlp_n_blk=g.mlp_n_blk, dim=g.dim)) for t in trees]


def train_params_to_state_dicts(params, cfg) -> Dict[str, Dict[str, List[
        StateDict]]]:
    """A JAX-package ``TrainState.params`` (numpy; ``params[direction]
    [gen|dis|cdis]``, each stacked (N, ...)) -> ``{direction: {group: N
    MUNIT-layout state dicts}}``, for ``CouncilTrainer.load_state``."""
    d = cfg.dis
    out: Dict[str, Dict[str, List[StateDict]]] = {}
    for direction, groups in params.items():
        out[direction] = {"gen": params_to_state_dicts(groups["gen"], cfg)}
        for group in ("dis", "cdis"):
            out[direction][group] = [
                _to_torch(export_ms_image_dis(t, d.n_layer, d.num_scales))
                for t in unstack_members(groups[group])]
    return out


def load_generator_state_dicts(checkpoint: str, cfg,
                               direction: str = "a2b") -> List[StateDict]:
    """Per-member generator state dicts from ``.npz`` (a JAX-package tree),
    ``.pt`` (reference-layout state dicts), or a training snapshot of the
    port: a ``step_XXXXXXXX`` directory, or the ``checkpoints/`` directory
    above it (the newest step is read)."""
    if checkpoint.endswith(".npz"):
        return params_to_state_dicts(load_params_npz(checkpoint), cfg)
    if checkpoint.endswith(".pt"):
        payload = torch.load(checkpoint, map_location="cpu",
                             weights_only=True)
        return [_to_torch(sd)
                for sd in extract_member_state_dicts(payload, direction)]
    if os.path.isdir(checkpoint):
        path = checkpoint
        if not re.fullmatch(r"step_\d+", os.path.basename(
                os.path.normpath(path))):
            found = latest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
            path = found[1]
        params = load_snapshot(path)["params"]
        if direction not in params:
            raise ValueError(f"snapshot {path} has no {direction!r} "
                             f"direction (it has {sorted(params)})")
        return [_to_torch(sd) for sd in params[direction]["gen"]]
    raise ValueError(
        f"unsupported checkpoint {checkpoint!r}: the port reads .npz, .pt "
        "and its own snapshot directories. Orbax training snapshots need "
        "JAX; export one with councilx.ckpt.manager.save_params_npz(path, "
        "load_generator_params(snapshot, cfg, direction)) first")


# ---------------------------------------------------------------------------
# training snapshots
# ---------------------------------------------------------------------------

SNAPSHOT_FILE = "state.pt"
_writer_lock = threading.Lock()
# the one snapshot write in flight (a thread) and the error of the last
_writer: Dict[str, Any] = {"thread": None, "error": None}


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(step, path) of every snapshot under ``root``, oldest first."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def latest_checkpoint(root: str) -> Optional[Tuple[int, str]]:
    """The newest snapshot (reference utils.py::get_model_list), or
    None."""
    cks = list_checkpoints(root)
    return cks[-1] if cks else None


def _gc_old(root: str, keep: int) -> None:
    for _, path in list_checkpoints(root)[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)


def _write(root: str, path: str, payload, keep: int) -> None:
    """torch.save into a temporary directory, then rename it to ``path``
    (replacing a snapshot of the same step), then drop all but the newest
    ``keep``."""
    tmp = os.path.join(root, f".{os.path.basename(path)}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, SNAPSHOT_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _gc_old(root, keep)


def _write_async(root: str, path: str, payload, keep: int) -> None:
    try:
        _write(root, path, payload, keep)
    except Exception as e:      # noqa: BLE001 -- raised by the next wait
        _writer["error"] = e


def save_checkpoint(root: str, state, step: int, keep: int = 3,
                    async_save: bool = False) -> str:
    """Snapshot ``state`` (a ``TrainState``) at ``step`` under
    ``root/step_%08d`` -> its path.

    The device-to-host copy (``state.snapshot()``) is done before this
    returns, because the train step updates the parameters in place; with
    ``async_save`` only the file write runs on, in a background thread, and
    :func:`wait_for_checkpoints` waits for it. One write is in flight at a
    time: a save first waits for the previous one."""
    path = os.path.abspath(_ckpt_dir(root, step))
    os.makedirs(root, exist_ok=True)
    with _writer_lock:
        wait_for_checkpoints()
        payload = state.snapshot()
        if async_save:
            t = threading.Thread(target=_write_async,
                                 args=(root, path, payload, keep),
                                 name="councilx_torch-ckpt")
            _writer["thread"] = t
            t.start()
        else:
            _write(root, path, payload, keep)
    return path


def wait_for_checkpoints() -> None:
    """Block until the snapshot write in flight, if any, is on disk; raise
    its error if it failed."""
    t = _writer["thread"]
    if t is not None:
        t.join()
        _writer["thread"] = None
    err, _writer["error"] = _writer["error"], None
    if err is not None:
        raise err


def load_snapshot(path: str) -> Dict[str, Any]:
    """The payload of the snapshot directory ``path``."""
    return torch.load(os.path.join(path, SNAPSHOT_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(root: str) -> Tuple[Dict[str, Any], int]:
    """(payload, step) of the newest snapshot under ``root``; the trainer's
    ``restore_state`` makes a ``TrainState`` of the payload."""
    found = latest_checkpoint(root)
    if found is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    step, path = found
    payload = load_snapshot(path)
    if int(payload["step"]) != step:
        raise ValueError(f"{path}: holds step {payload['step']}")
    return payload, step
