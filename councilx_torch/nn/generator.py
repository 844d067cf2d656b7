"""AdaIN generator (reference networks.py::AdaINGen and submodules).

Counterpart of ``councilx/nn/generator.py``, NHWC throughout:

  ContentEncoder: 7x7 conv (IN) -> n_downsample x stride-2 4x4 convs (IN,
      channel doubling) -> n_res ResBlocks (IN)
  StyleEncoder:   7x7 conv -> 2 x stride-2 doubling convs ->
      (n_downsample-2) x stride-2 convs -> global avg pool -> 1x1 conv
  Decoder:        n_res AdaIN ResBlocks -> n_upsample x [nearest-2x
      upsample + 5x5 conv (MUNIT LayerNorm)] -> 7x7 conv -> tanh
  MLP:            style code -> per-AdaIN-layer (beta, gamma), flat

Module attributes follow the reference's ``nn.Sequential`` indices, so the
state-dict keys are MUNIT's (``enc_content.model.3.model.0.model.1.conv.
weight``, ``enc_style.model.4.weight``, ``dec.model.2.norm.gamma`` ...);
the parameterless slots (avg pool, upsample) keep their index.

``remat_stages`` (training only) recomputes the content encoder's and the
decoder's stages in the backward, one ``torch.utils.checkpoint`` each, as
the JAX package wraps them in ``nn.remat``: the encoder's 7x7 block, each
downsample block and the resblock stack; the decoder's resblock stack, each
upsample stage (the nearest-2x upsample and its 5x5 block, which the JAX
package's ``Conv2dBlock`` holds as one) and the final 7x7 block. Not the
style encoder (``councilx/nn/generator.py`` measured it raising the peak).
No checkpoint is entered while gradients are off, so serving is unchanged.

With the focus mask the decoder emits RGB + 1 mask channel;
:func:`composite_with_mask` blends ``mask * rgb + (1 - mask) * input``.

The JAX generator's conv engines (``Conv2dBlock``): the three 7x7 convs
fold their reflect pad in (``fuse_pad``, by ``boundary_engine``; at the
default "auto" each is channel-starved, so phase_fused); the decoder's
upsample convs take the pre-upsample input and run the fused op under
``fuse_upsample`` (by ``upsample_engine``); ``resblock_fuse_pad`` folds the
resblock convs' pad in as well. The decoder keeps its ``Upsample2x`` slots
(their indices are MUNIT's), but each upsample block upsamples itself.

W8A8 serving (``quant``, ``ops/quant.py``) quantizes the JAX package's
``quant_scope``: "resblocks" the 16 resblock 3x3 convs; "heavy" also the
encoder's two stride-2 downsamples and the decoder's two upsample convs
(with ``fuse_upsample``, each a quantized phase conv on the pre-upsample
input; without, upsample, then the quantized 5x5). The first and last 7x7
convs, the style encoder and the MLP stay in the compute dtype.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from councilx_torch.nn.blocks import (MLP, AdaINPair, Conv2dBlock,
                                      GlobalAvgPool, ResBlocks, Upsample2x,
                                      _Conv)


def run_stage(remat: bool, fn, *args):
    """fn(*args), its activations recomputed in the backward when
    ``remat`` and gradients are on (one checkpointed stage)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class ContentEncoder(nn.Module):
    """Reference: networks.py::ContentEncoder."""

    def __init__(self, input_dim: int = 3, dim: int = 64,
                 n_downsample: int = 2, n_res: int = 4, activ: str = "relu",
                 pad_type: str = "reflect", quant: str = "none",
                 quant_scope: str = "resblocks", remat_stages: bool = False,
                 boundary_engine: str = "auto",
                 resblock_fuse_pad: bool = False, device=None):
        super().__init__()
        self.remat_stages = remat_stages
        layers: List[nn.Module] = [Conv2dBlock(
            input_dim, dim, 7, 1, 3, norm="in", activation=activ,
            pad_type=pad_type, fuse_pad=True,
            boundary_engine=boundary_engine, device=device)]
        for _ in range(n_downsample):
            layers.append(Conv2dBlock(
                dim, 2 * dim, 4, 2, 1, norm="in", activation=activ,
                pad_type=pad_type,
                quant=quant if quant_scope == "heavy" else "none",
                device=device))
            dim *= 2
        layers.append(ResBlocks(n_res, dim, norm="in", activation=activ,
                                pad_type=pad_type, quant=quant,
                                fuse_pad=resblock_fuse_pad, device=device))
        self.model = nn.ModuleList(layers)
        self.output_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model:
            x = run_stage(self.remat_stages, layer, x)
        return x


class StyleEncoder(nn.Module):
    """Reference: networks.py::StyleEncoder. Returns (B, style_dim)."""

    def __init__(self, input_dim: int = 3, dim: int = 64,
                 style_dim: int = 8, n_downsample: int = 2,
                 activ: str = "relu", pad_type: str = "reflect",
                 boundary_engine: str = "auto", device=None):
        super().__init__()
        layers: List[nn.Module] = [Conv2dBlock(
            input_dim, dim, 7, 1, 3, norm="none", activation=activ,
            pad_type=pad_type, fuse_pad=True,
            boundary_engine=boundary_engine, device=device)]
        for _ in range(2):
            layers.append(Conv2dBlock(dim, 2 * dim, 4, 2, 1, norm="none",
                                      activation=activ, pad_type=pad_type,
                                      device=device))
            dim *= 2
        for _ in range(n_downsample - 2):
            layers.append(Conv2dBlock(dim, dim, 4, 2, 1, norm="none",
                                      activation=activ, pad_type=pad_type,
                                      device=device))
        layers.append(GlobalAvgPool())
        layers.append(_Conv(dim, style_dim, 1, device=device))
        self.model = nn.ModuleList(layers)
        self.style_dim = style_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model[:-1]:
            x = layer(x)
        final = self.model[-1]
        x = x.reshape(x.shape[0], -1)
        w = final.weight.reshape(self.style_dim, -1).to(x.dtype)
        return F.linear(x, w, final.bias.to(x.dtype))


class Decoder(nn.Module):
    """Reference: networks.py::Decoder (AdaIN resblocks + upsample convs).

    ``adain_vec`` is the flat MLP output of length ``2 * dim * 2 * n_res``,
    sliced in order — per AdaIN layer: beta first, then gamma — as
    AdaINGen.assign_adain_params does."""

    def __init__(self, dim: int, output_dim: int = 3, n_upsample: int = 2,
                 n_res: int = 4, activ: str = "relu",
                 pad_type: str = "reflect", ln_precision: str = "f32",
                 ln_stats: str = "two_pass",
                 mask_activation: str = "tanh_affine", quant: str = "none",
                 quant_scope: str = "resblocks", fuse_upsample: bool = True,
                 remat_stages: bool = False, boundary_engine: str = "auto",
                 upsample_engine: str = "dilated",
                 resblock_fuse_pad: bool = False, device=None):
        super().__init__()
        self.dim = dim
        self.n_res = n_res
        self.remat_stages = remat_stages
        self.sigmoid_mask = (mask_activation == "sigmoid" and output_dim > 3)
        up_quant = quant if quant_scope == "heavy" else "none"
        layers: List[nn.Module] = [ResBlocks(
            n_res, dim, norm="adain", activation=activ, pad_type=pad_type,
            quant=quant, fuse_pad=resblock_fuse_pad, device=device)]
        for _ in range(n_upsample):
            layers.append(Upsample2x())
            layers.append(Conv2dBlock(dim, dim // 2, 5, 1, 2, norm="ln",
                                      activation=activ, pad_type=pad_type,
                                      in_precision=ln_precision,
                                      in_stats=ln_stats, quant=up_quant,
                                      upsample2x=True,
                                      fuse_upsample=fuse_upsample,
                                      upsample_engine=upsample_engine,
                                      device=device))
            dim //= 2
        layers.append(Conv2dBlock(
            dim, output_dim, 7, 1, 3, norm="none",
            activation="none" if self.sigmoid_mask else "tanh",
            pad_type=pad_type, fuse_pad=True,
            boundary_engine=boundary_engine, device=device))
        self.model = nn.ModuleList(layers)

    @staticmethod
    def _stage(layers, x: torch.Tensor) -> torch.Tensor:
        # the upsample blocks upsample (or fuse it) themselves
        for layer in layers:
            if not isinstance(layer, Upsample2x):
                x = layer(x)
        return x

    @staticmethod
    def num_adain_params(dim: int, n_res: int) -> int:
        """2 params x dim features x 2 AdaIN convs per resblock x n_res."""
        return 2 * dim * 2 * n_res

    def forward(self, x: torch.Tensor, adain_vec: torch.Tensor
                ) -> torch.Tensor:
        dim = self.dim
        pairs: List[AdaINPair] = []
        for i in range(2 * self.n_res):
            beta = adain_vec[:, 2 * i * dim:(2 * i + 1) * dim]
            gamma = adain_vec[:, (2 * i + 1) * dim:(2 * i + 2) * dim]
            pairs.append((gamma, beta))
        x = run_stage(self.remat_stages, self.model[0], x, pairs)
        # the upsample stages ((Upsample2x, 5x5 block) pairs), the 7x7 block
        stages = [self.model[i:i + 2] for i in range(1, len(self.model) - 1,
                                                     2)]
        stages.append(self.model[-1:])
        for stage in stages:
            x = run_stage(self.remat_stages, self._stage, stage, x)
        if self.sigmoid_mask:
            x = torch.cat([torch.tanh(x[..., :3]), x[..., 3:]], dim=-1)
        return x


class AdaINGen(nn.Module):
    """Reference: networks.py::AdaINGen — encoder/decoder generator.

    ``ln_precision``/``ln_stats`` set the decoder's MUNIT LayerNorm (see
    MunitLayerNorm); the IN/AdaIN sites always use the instance-norm
    kernel's numerics. ``quant``/``quant_scope``: the W8A8 convs;
    ``fuse_upsample``, ``upsample_engine``, ``boundary_engine`` and
    ``resblock_fuse_pad``: the conv engines (module docstring);
    ``remat_stages``: per-stage recompute; the state dict is the same in
    every mode."""

    def __init__(self, input_dim: int = 3, dim: int = 64, style_dim: int = 8,
                 n_downsample: int = 2, n_res: int = 4, activ: str = "relu",
                 pad_type: str = "reflect", mlp_dim: int = 256,
                 mlp_n_blk: int = 3, focus_mask: bool = True,
                 ln_precision: str = "f32", ln_stats: str = "two_pass",
                 mask_activation: str = "tanh_affine", quant: str = "none",
                 quant_scope: str = "resblocks", fuse_upsample: bool = True,
                 remat_stages: bool = False, boundary_engine: str = "auto",
                 upsample_engine: str = "dilated",
                 resblock_fuse_pad: bool = False, device=None):
        super().__init__()
        if quant_scope not in ("resblocks", "heavy"):
            raise ValueError(f"unknown quant_scope: {quant_scope}")
        output_dim = input_dim + (1 if focus_mask else 0)
        self.enc_content = ContentEncoder(
            input_dim, dim, n_downsample, n_res, activ, pad_type, quant,
            quant_scope, remat_stages, boundary_engine=boundary_engine,
            resblock_fuse_pad=resblock_fuse_pad, device=device)
        self.enc_style = StyleEncoder(input_dim, dim, style_dim,
                                      n_downsample, activ, pad_type,
                                      boundary_engine=boundary_engine,
                                      device=device)
        content_dim = self.enc_content.output_dim
        self.dec = Decoder(content_dim, output_dim, n_downsample, n_res,
                           activ, pad_type, ln_precision, ln_stats,
                           mask_activation, quant, quant_scope,
                           fuse_upsample, remat_stages,
                           boundary_engine=boundary_engine,
                           upsample_engine=upsample_engine,
                           resblock_fuse_pad=resblock_fuse_pad,
                           device=device)
        self.mlp = MLP(style_dim, Decoder.num_adain_params(content_dim, n_res),
                       mlp_dim, mlp_n_blk, norm="none", activation=activ,
                       device=device)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (content (B,h,w,C), style (B, style_dim))."""
        return self.enc_content(x), self.enc_style(x)

    def encode_content(self, x: torch.Tensor) -> torch.Tensor:
        return self.enc_content(x)

    def encode_style(self, x: torch.Tensor) -> torch.Tensor:
        return self.enc_style(x)

    def decode(self, content: torch.Tensor, style: torch.Tensor
               ) -> torch.Tensor:
        """Style (B, style_dim) -> AdaIN params -> decoded (B, H, W,
        output_dim); channel 3 (if present) is the raw mask channel."""
        return self.dec(content, self.mlp(style))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Autoencode with the image's own style."""
        content, style = self.encode(x)
        return self.decode(content, style)

    def quant_blocks(self) -> Dict[str, Conv2dBlock]:
        """The quantized conv blocks by module name (empty under quant
        'none'), in definition order."""
        return {name: m for name, m in self.named_modules()
                if isinstance(m, Conv2dBlock) and m.quant != "none"}

    def quant_stats(self) -> Dict[str, torch.Tensor]:
        """Each quantized block's ``act_absmax`` (0-d f32) by name."""
        return {name: m.act_absmax for name, m in self.quant_blocks().items()}

    def set_quant_stats(self, stats: Mapping[str, torch.Tensor]) -> None:
        """Set every quantized block's calibrated absmax from ``stats`` (by
        module name; extra names are ignored); raise if one is missing."""
        blocks = self.quant_blocks()
        missing = sorted(set(blocks) - set(stats))
        if missing:
            raise KeyError(f"no calibrated stat for {missing}")
        for name, m in blocks.items():
            m.set_quant_stat(stats[name])

    def prepare_quant(self, dtype: torch.dtype) -> None:
        """Make every quantized block's int8 weight for ``dtype`` now (each
        is made once per weight value; this keeps it out of the first
        call)."""
        for m in self.quant_blocks().values():
            m.quant_weight(dtype)


def engine_kwargs(cfg) -> dict:
    """AdaINGen's conv-engine arguments from a ``Config``, as the JAX
    package's Translator and CouncilTrainer pass them: ``parity_mode``
    takes the reference route (no fused upsample, the reference boundary
    engine, no ``resblock_fuse_pad``)."""
    parity = cfg.parity_mode
    return {"fuse_upsample": cfg.fuse_upsample and not parity,
            "boundary_engine": ("reference" if parity
                                else cfg.boundary_engine),
            "upsample_engine": cfg.upsample_engine,
            "resblock_fuse_pad": cfg.resblock_fuse_pad and not parity}


def composite_with_mask(decoded: torch.Tensor, x_in: torch.Tensor,
                        mask_activation: str = "tanh_affine"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Focus-mask compositing (reference: trainer_council.py gen_update).

    With "tanh_affine" the mask channel is tanh output mapped to [0, 1];
    with "sigmoid" it is a raw logit squashed by sigmoid. Returns
    (mask * rgb + (1 - mask) * x_in, mask)."""
    rgb = decoded[..., :3]
    m = decoded[..., 3:4]
    if mask_activation == "sigmoid":
        mask = torch.sigmoid(m)
    else:
        mask = (m + 1.0) * 0.5
    return mask * rgb + (1.0 - mask) * x_in, mask
