"""Checkpoints: generator ``.npz`` exports and reference ``.pt`` for
serving, and JAX-package training parameters for the trainer.

Counterpart of ``councilx/ckpt/manager.py:149-202``. Both formats become N
per-member MUNIT-layout state dicts of float32 tensors, which the port's
``AdaINGen`` loads with ``load_state_dict(strict=True)``. The JAX package's
orbax training snapshots need JAX to read; export them to ``.npz`` first.
"""

from __future__ import annotations

from typing import Any, Dict, List

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
    """Per-member generator state dicts from ``.npz`` (a JAX-package tree)
    or ``.pt`` (reference-layout state dicts)."""
    if checkpoint.endswith(".npz"):
        return params_to_state_dicts(load_params_npz(checkpoint), cfg)
    if checkpoint.endswith(".pt"):
        payload = torch.load(checkpoint, map_location="cpu",
                             weights_only=True)
        return [_to_torch(sd)
                for sd in extract_member_state_dicts(payload, direction)]
    raise ValueError(
        f"unsupported checkpoint {checkpoint!r}: the port reads .npz and "
        ".pt. Orbax training snapshots need JAX; export one with "
        "councilx.ckpt.manager.save_params_npz(path, "
        "load_generator_params(snapshot, cfg, direction)) first")
