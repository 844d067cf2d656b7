"""InceptionV3 pool3 feature extractor (NHWC in, 2048-d out) for FID/KID.

Counterpart of ``councilx/eval/inception.py``: torchvision's
``inception_v3`` up to the 2048-d average-pool features, with the
``pytorch-fid`` pooling changes (``fid_variant=True``: the branch average
pools leave the padding out of their count and Mixed_7c's pool branch takes
the maximum), so that with converted ``pt_inception-2015-12-05`` or
torchvision weights the FID numbers compare with the standard tooling.

Parameter names are torchvision's (``Mixed_5b.branch1x1.conv.weight``,
``...bn.running_mean``): a torchvision or pytorch-fid state dict loads with
``strict=True`` once ``fc.*`` and ``AuxLogits.*`` are dropped
(:func:`load_weights`). The flat ``.npz`` that the JAX package reads
(``tools/convert_inception_pt.py``) is carried across by
:func:`state_dict_from_npz`. No pretrained weights ship with the repo.

Input: (B, H, W, 3) float in [-1, 1] (pytorch-fid's normalize_input),
resized to 299x299 by the caller (PIL, ``eval/features.py``) or with
``resize_input=True`` (bilinear, antialiased when shrinking, as
``jax.image.resize``).

The convolutions are cuDNN's (``F.conv2d``): the JAX package computes them
with XLA's convolution and no hand kernel. They run in float32 with TF32
off for the whole forward pass, whatever the process's setting: PyTorch
leaves cuDNN's TF32 on by default, which moves the features by ~1e-3
relative against the JAX package's full-f32 reference, and FID with them.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from councilx_torch.data.ondevice import resize_bilinear

StateDict = Dict[str, torch.Tensor]


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN and cuBLAS inside the block; the previous
    settings come back after it."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm(eps=1e-3, running statistics) + relu."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, _pair(kernel_size), _pair(stride),
                              _pair(padding), bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _branch_pool(x, fid_variant: bool):
    """The A/C/E blocks' 3x3 stride-1 average pool: count_include_pad=False
    in the FID variant, torchvision's default otherwise."""
    return F.avg_pool2d(x, 3, stride=1, padding=1,
                        count_include_pad=not fid_variant)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_branch_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for blk in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                    self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = blk(bd)
        bp = self.branch_pool(_branch_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for blk in (self.branch7x7x3_2, self.branch7x7x3_3,
                    self.branch7x7x3_4):
            b7 = blk(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """pytorch-fid: Mixed_7b's pool branch averages without the padding,
    Mixed_7c's takes the maximum (``pool_mode="max"``)."""

    def __init__(self, cin: int, pool_mode: str, fid_variant: bool):
        super().__init__()
        self.pool_mode, self.fid_variant = pool_mode, fid_variant
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        pool = (F.max_pool2d(x, 3, stride=1, padding=1)
                if self.pool_mode == "max"
                else _branch_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pool)],
                         1)


class InceptionV3Features(nn.Module):
    """Backbone up to the 2048-d global-average-pool features, on
    ``device`` (the card unless the caller asks for another); its state
    stays float32."""

    def __init__(self, fid_variant: bool = True, resize_input: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        fv = fid_variant
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max" if fv else "avg", fv)
        self.to(device).eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.Conv2d_1a_3x3.conv.weight.device

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [-1, 1], on any device -> (B, 2048) float32
        features on this module's device."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        if self.resize_input and tuple(x.shape[1:3]) != (299, 299):
            x = resize_bilinear(x, 299, 299)
        x = x.permute(0, 3, 1, 2)
        with tf32_off():
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, 2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, 2)
            for blk in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                        self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                        self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                        self.Mixed_7b, self.Mixed_7c):
                x = blk(x)
            return x.mean(dim=(2, 3))


def init_random(model: InceptionV3Features, generator: torch.Generator
                ) -> InceptionV3Features:
    """Random weights, drawn in parameter order from ``generator`` on the
    CPU: convs He-normal over their fan-in (so activations keep their
    scale through the 94 relu layers), BatchNorm the identity (scale 1,
    bias 0, mean 0, var 1). For shape tests and smoke runs only: the
    numbers are not comparable FID values (and not the JAX package's
    random init)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                w = mod.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        * (2.0 / fan_in) ** 0.5)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model


def state_dict_from_npz(flat: Mapping[str, np.ndarray]) -> StateDict:
    """The flat ``.npz`` the JAX package loads (``load_params_npz``; written
    by ``tools/convert_inception_pt.py``) -> this module's state dict: the
    inverse of that tool's ``convert``. ``params/<scope>/kernel`` HWIO ->
    ``<scope>.weight`` OIHW, ``scale``/``bias`` -> ``bn.weight``/``bn.bias``,
    ``batch_stats/<scope>/mean``/``var`` -> ``running_mean``/
    ``running_var``."""
    sd: StateDict = {}
    for key, arr in flat.items():
        kind, *scope, leaf = key.split("/")
        path = ".".join(scope)
        arr = np.asarray(arr, np.float32)
        if kind == "params" and leaf == "kernel":
            sd[f"{path}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif kind == "params" and leaf in ("scale", "bias"):
            sd[f"{path}.{'weight' if leaf == 'scale' else 'bias'}"] = (
                torch.from_numpy(arr.copy()))
        elif kind == "batch_stats" and leaf in ("mean", "var"):
            sd[f"{path}.running_{leaf}"] = torch.from_numpy(arr.copy())
            if leaf == "mean":
                sd[f"{path}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(f"unrecognized Inception tensor: {key}")
    return sd


def load_weights(model: InceptionV3Features, path: str
                 ) -> InceptionV3Features:
    """Load converted weights into ``model`` (strict): the JAX package's
    ``.npz`` (``tools/convert_inception_pt.py``), or a torchvision /
    pytorch-fid ``.pt``/``.pth`` state dict (``fc.*`` and ``AuxLogits.*``
    dropped, a missing ``num_batches_tracked`` filled with 0)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            sd = state_dict_from_npz({k: data[k] for k in data.files})
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        obj = obj.get("state_dict", obj)
        sd = {k: v for k, v in obj.items()
              if not k.startswith(("fc.", "AuxLogits."))}
        for k in list(sd):
            if k.endswith(".bn.running_mean"):
                sd.setdefault(k[:-len("running_mean")]
                              + "num_batches_tracked", torch.tensor(0))
    model.load_state_dict(sd, strict=True)
    return model


class MissingWeights(ValueError):
    """No Inception weights were given, and random ones were not allowed."""


def make_inception(weights, device="cuda", allow_random: bool = False
                   ) -> InceptionV3Features:
    """The FID variant on ``device``, with the weights rules of the eval
    and FID CLIs and the in-training hook: ``weights`` is a file for
    :func:`load_weights`, or the literal ``"random"``; with no ``weights``,
    ``allow_random`` takes random ones, and otherwise
    :class:`MissingWeights` is raised. Random weights (:func:`init_random`
    with seed 0; smoke tests only) print a warning: the numbers compare
    with nothing."""
    model = InceptionV3Features(device=device)
    if weights and weights != "random":
        return load_weights(model, weights)
    if weights != "random" and not allow_random:
        raise MissingWeights(
            "InceptionV3 weights required: an .npz from "
            "tools/convert_inception_pt.py or a torchvision/pytorch-fid "
            ".pt/.pth state dict (or 'random' for smoke tests)")
    print("WARNING: random Inception weights — numbers are NOT "
          "comparable FID/KID values", file=sys.stderr)
    return init_random(model, torch.Generator().manual_seed(0))
