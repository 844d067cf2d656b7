"""JAX-package parameter trees -> MUNIT-layout state dicts, numpy only.

Counterpart of ``councilx/ckpt/torch_export.py``: the same mappings as
``export_adain_gen`` and ``export_ms_image_dis``, so a tree saved by the JAX
package (``jax.device_get(params)`` or ``load_params_npz``) loads into the
port's ``AdaINGen`` or ``MsImageDis`` with
``load_state_dict(strict=True)``. Conv kernels go HWIO -> OIHW, Dense
kernels (in, out) -> Linear (out, in), and the decoder's AdaIN layers get
the ``running_mean``/``running_var`` buffers the reference registers but
never reads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np

Array = np.ndarray
Params = Mapping[str, Any]


def _k(p: Params, *path) -> Array:
    out: Any = p
    for name in path:
        out = out[name]
    return np.asarray(out)


def _conv_kernel_inv(kernel: Array) -> Array:
    """(kH, kW, I, O) -> (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def _conv_block_inv(p: Params, prefix: str, norm: str = "none",
                    adain_dim: int = 0) -> Dict[str, Array]:
    out = {
        f"{prefix}.conv.weight": _conv_kernel_inv(_k(p, "Conv_0", "kernel")),
        f"{prefix}.conv.bias": _k(p, "Conv_0", "bias"),
    }
    if norm == "ln":
        out[f"{prefix}.norm.gamma"] = _k(p, "MunitLayerNorm_0", "gamma")
        out[f"{prefix}.norm.beta"] = _k(p, "MunitLayerNorm_0", "beta")
    elif norm == "adain":
        out[f"{prefix}.norm.running_mean"] = np.zeros(adain_dim, np.float32)
        out[f"{prefix}.norm.running_var"] = np.ones(adain_dim, np.float32)
    return out


def _res_blocks_inv(p: Params, prefix: str, n_res: int, norm: str = "in",
                    dim: int = 0) -> Dict[str, Array]:
    out: Dict[str, Array] = {}
    for i in range(n_res):
        blk = p[f"ResBlock_{i}"]
        for j in (0, 1):
            out.update(_conv_block_inv(
                blk[f"Conv2dBlock_{j}"], f"{prefix}.model.{i}.model.{j}",
                norm=norm, adain_dim=dim))
    return out


def export_content_encoder(p: Params, prefix: str = "enc_content",
                           n_downsample: int = 2, n_res: int = 4
                           ) -> Dict[str, Array]:
    out: Dict[str, Array] = {}
    for i in range(1 + n_downsample):
        out.update(_conv_block_inv(p[f"Conv2dBlock_{i}"],
                                   f"{prefix}.model.{i}"))
    out.update(_res_blocks_inv(p["ResBlocks_0"],
                               f"{prefix}.model.{1 + n_downsample}", n_res))
    return out


def export_style_encoder(p: Params, prefix: str = "enc_style",
                         n_downsample: int = 2) -> Dict[str, Array]:
    out: Dict[str, Array] = {}
    n_blocks = 1 + 2 + (n_downsample - 2)
    for i in range(n_blocks):
        out.update(_conv_block_inv(p[f"Conv2dBlock_{i}"],
                                   f"{prefix}.model.{i}"))
    final_idx = n_blocks + 1  # the AdaptiveAvgPool2d occupies one slot
    out[f"{prefix}.model.{final_idx}.weight"] = _conv_kernel_inv(
        _k(p, "Conv_0", "kernel"))
    out[f"{prefix}.model.{final_idx}.bias"] = _k(p, "Conv_0", "bias")
    return out


def export_decoder(p: Params, prefix: str = "dec", n_upsample: int = 2,
                   n_res: int = 4, content_dim: int = 256
                   ) -> Dict[str, Array]:
    out = _res_blocks_inv(p["ResBlocks_0"], f"{prefix}.model.0", n_res,
                          norm="adain", dim=content_dim)
    for u in range(n_upsample):
        t_idx = 1 + 2 * u + 1  # each (Upsample, Conv2dBlock) pair
        out.update(_conv_block_inv(p[f"Conv2dBlock_{u}"],
                                   f"{prefix}.model.{t_idx}", norm="ln"))
    final_idx = 1 + 2 * n_upsample
    out.update(_conv_block_inv(p[f"Conv2dBlock_{n_upsample}"],
                               f"{prefix}.model.{final_idx}"))
    return out


def export_mlp(p: Params, prefix: str = "mlp", n_blk: int = 3
               ) -> Dict[str, Array]:
    out: Dict[str, Array] = {}
    for i in range(n_blk):
        out[f"{prefix}.model.{i}.fc.weight"] = np.ascontiguousarray(
            _k(p, f"LinearBlock_{i}", "Dense_0", "kernel").T)
        out[f"{prefix}.model.{i}.fc.bias"] = _k(p, f"LinearBlock_{i}",
                                                "Dense_0", "bias")
    return out


def export_adain_gen(params: Params, n_downsample: int = 2, n_res: int = 4,
                     mlp_n_blk: int = 3, dim: int = 64) -> Dict[str, Array]:
    """Single-member AdaINGen parameter tree -> MUNIT state dict (numpy)."""
    content_dim = dim * (2 ** n_downsample)
    out: Dict[str, Array] = {}
    out.update(export_content_encoder(params["enc_content"], "enc_content",
                                      n_downsample, n_res))
    out.update(export_style_encoder(params["enc_style"], "enc_style",
                                    n_downsample))
    out.update(export_decoder(params["dec"], "dec", n_downsample, n_res,
                              content_dim))
    out.update(export_mlp(params["mlp"], "mlp", mlp_n_blk))
    return out


def export_ms_image_dis(params: Params, n_layer: int = 4,
                        num_scales: int = 3) -> Dict[str, Array]:
    """Single-member MsImageDis parameter tree -> MUNIT state dict (numpy):
    ``cnns.{s}.{l}.conv.*`` for the 4x4 blocks, ``cnns.{s}.{n_layer}.*``
    for the final 1x1 conv."""
    out: Dict[str, Array] = {}
    for s in range(num_scales):
        scale = params[f"scale_{s}"]
        for layer in range(n_layer):
            out.update(_conv_block_inv(scale[f"Conv2dBlock_{layer}"],
                                       f"cnns.{s}.{layer}"))
        out[f"cnns.{s}.{n_layer}.weight"] = _conv_kernel_inv(
            _k(scale, "Conv_0", "kernel"))
        out[f"cnns.{s}.{n_layer}.bias"] = _k(scale, "Conv_0", "bias")
    return out


def unstack_members(stacked: Params) -> List[Dict[str, Any]]:
    """Split a stacked (N, ...) nested dict of arrays into N member trees."""
    def leaves(t):
        for v in t.values():
            if isinstance(v, Mapping):
                yield from leaves(v)
            else:
                yield v

    n = int(np.asarray(next(leaves(stacked))).shape[0])

    def take(t, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in t.items()}

    return [take(stacked, i) for i in range(n)]
