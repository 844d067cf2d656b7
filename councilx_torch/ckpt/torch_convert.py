"""Reference checkpoint payloads -> per-member generator state dicts, and
MUNIT-layout state dicts -> the JAX package's parameter trees.

Counterpart of ``councilx/ckpt/torch_convert.py``, numpy only. The port's
modules use the reference's MUNIT names, so a reference state dict needs no
key or layout conversion to load here; only the payload's outer keying has
to be resolved (:func:`extract_member_state_dicts`). The JAX package's
``AdaINGen`` takes flax trees instead (:func:`convert_adain_gen`, the
inverse of ``torch_export.export_adain_gen``):

  Conv2d weight (O, I, kH, kW) -> flax kernel (kH, kW, I, O)
  Linear weight (O, I)         -> flax kernel (I, O)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np

Array = np.ndarray
SD = Mapping[str, Array]


def _conv_kernel(w: Array) -> Array:
    return np.transpose(w, (2, 3, 1, 0))


def _conv_block(sd: SD, prefix: str, norm: str = "none") -> Dict[str, Any]:
    out: Dict[str, Any] = {"Conv_0": {
        "kernel": _conv_kernel(sd[f"{prefix}.conv.weight"]),
        "bias": sd[f"{prefix}.conv.bias"],
    }}
    if norm == "ln":
        out["MunitLayerNorm_0"] = {
            "gamma": sd[f"{prefix}.norm.gamma"],
            "beta": sd[f"{prefix}.norm.beta"],
        }
    return out


def _res_blocks(sd: SD, prefix: str, n_res: int, norm: str = "in"
                ) -> Dict[str, Any]:
    return {f"ResBlock_{i}": {
        f"Conv2dBlock_{j}": _conv_block(sd, f"{prefix}.model.{i}.model.{j}",
                                        norm=norm)
        for j in (0, 1)} for i in range(n_res)}


def convert_adain_gen(sd: SD, n_downsample: int = 2, n_res: int = 4,
                      mlp_n_blk: int = 3) -> Dict[str, Any]:
    """One member's AdaINGen state dict (numpy) -> its flax parameter
    tree. The AdaIN layers' ``running_mean``/``running_var`` buffers (never
    read) are dropped."""
    enc: Dict[str, Any] = {f"Conv2dBlock_{i}": _conv_block(
        sd, f"enc_content.model.{i}") for i in range(1 + n_downsample)}
    enc["ResBlocks_0"] = _res_blocks(
        sd, f"enc_content.model.{1 + n_downsample}", n_res)
    n_style = 1 + 2 + (n_downsample - 2)
    style: Dict[str, Any] = {f"Conv2dBlock_{i}": _conv_block(
        sd, f"enc_style.model.{i}") for i in range(n_style)}
    final = n_style + 1  # the AdaptiveAvgPool2d occupies one slot
    style["Conv_0"] = {
        "kernel": _conv_kernel(sd[f"enc_style.model.{final}.weight"]),
        "bias": sd[f"enc_style.model.{final}.bias"]}
    dec: Dict[str, Any] = {"ResBlocks_0": _res_blocks(
        sd, "dec.model.0", n_res, norm="none")}
    for u in range(n_downsample):
        # each (Upsample, Conv2dBlock) pair: skip the parameterless Upsample
        dec[f"Conv2dBlock_{u}"] = _conv_block(sd, f"dec.model.{2 + 2 * u}",
                                              norm="ln")
    dec[f"Conv2dBlock_{n_downsample}"] = _conv_block(
        sd, f"dec.model.{1 + 2 * n_downsample}")
    mlp = {f"LinearBlock_{i}": {"Dense_0": {
        "kernel": sd[f"mlp.model.{i}.fc.weight"].T,
        "bias": sd[f"mlp.model.{i}.fc.bias"]}} for i in range(mlp_n_blk)}
    return {"enc_content": enc, "enc_style": style, "dec": dec, "mlp": mlp}


def state_dicts_to_params(state_dicts: Sequence[Mapping[str, Any]], cfg
                          ) -> Dict[str, Any]:
    """N per-member MUNIT-layout state dicts (tensors or arrays) -> the
    stacked (N, ...) generator tree the JAX package's ``Translator`` and
    ``load_params_npz`` take: the inverse of
    ``ckpt.manager.params_to_state_dicts``."""
    g = cfg.gen
    trees = [convert_adain_gen(
        {k: np.asarray(v) for k, v in sd.items()},
        n_downsample=g.n_downsample, n_res=g.n_res, mlp_n_blk=g.mlp_n_blk)
        for sd in state_dicts]

    def stack(*nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return np.stack(nodes)

    return stack(*trees)


def extract_member_state_dicts(payload, direction: str):
    """Pick the per-member generator state dicts for one direction out of a
    reference checkpoint payload. Every plausible layout is handled:
    {'a2b_0': sd, ...}, {'a2b': [sd, ...]} / {'a2b': sd} (and the MUNIT-style
    short keys {'a': ...}), {'0': sd, ...}, a bare list, or a raw single
    state dict."""
    if isinstance(payload, (list, tuple)):
        return list(payload)
    if not isinstance(payload, dict):
        raise ValueError(f"unrecognized checkpoint payload: {type(payload)}")
    # raw state dict? (keys look like 'enc_content.model.0.conv.weight')
    if any("." in k for k in payload.keys()):
        return [payload]
    keys = sorted(payload.keys())
    member_keys = [k for k in keys if k.startswith(f"{direction}_")]
    if member_keys:
        return [payload[k] for k in sorted(
            member_keys, key=lambda s: int(s.rsplit("_", 1)[1]))]
    short = {"a2b": "a", "b2a": "b"}[direction]
    for cand in (direction, short):
        if cand in payload:
            inner = payload[cand]
            return (list(inner) if isinstance(inner, (list, tuple))
                    else [inner])
    if all(k.isdigit() for k in keys):
        return [payload[k] for k in sorted(keys, key=int)]
    raise ValueError(f"cannot find direction '{direction}' members among "
                     f"keys {keys}")
