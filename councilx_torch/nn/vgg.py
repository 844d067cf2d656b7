"""VGG16 perceptual loss (MUNIT's networks.py::Vgg16 and the trainer's
compute_vgg_loss), in PyTorch.

Counterpart of ``councilx/nn/vgg.py``, NHWC at every function:

  * :func:`vgg_preprocess`: [-1, 1] RGB -> 0..255 BGR minus the ImageNet
    channel means (the caffe-VGG convention of the reference's weights),
    computed in the input's dtype, as the JAX function does;
  * :class:`Vgg16Features`: the 13-conv VGG16 trunk up to relu5_3. Its
    convs and pools run in float32 whatever the input's dtype, as flax's
    ``nn.Conv`` (``dtype=None``, float32 parameters) promotes them: in a
    bf16 step the preprocess rounds in bf16, the trunk does not;
  * :func:`compute_vgg_loss`: the mean squared difference of the
    instance-normalized (two-pass f32 statistics, eps 1e-5, biased
    variance) relu5_3 features of the translation and of the input.

Weights (:func:`load_vgg`): the JAX package's ``.npz`` of
``tools/convert_vgg_pt.py`` (flat ``convX_Y/kernel`` HWIO and
``convX_Y/bias``), or a torch state dict, torchvision's ``vgg16().features``
(``features.N.*``) or ``convX_Y.*``, in a ``.pt``/``.pth`` file. The module
names its parameters ``convX_Y.weight`` (OIHW) and ``convX_Y.bias``. No
kernel site: the JAX package runs these convs as XLA convs, so
``F.conv2d`` / ``F.max_pool2d`` run them here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from councilx_torch.nn.blocks import make_kernel_init, norm_mean_var

# VGG16 conv plan: (name, out_channels); 'M' = 2x2 max pool
_VGG16_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]

# ImageNet channel means, BGR order, 0..255 scale (caffe convention)
_BGR_MEANS = (103.939, 116.779, 123.680)

# torchvision vgg16().features index -> layer name (tools/convert_vgg_pt.py)
_IDX2NAME = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}
_N_TENSORS = 26


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] RGB NHWC -> caffe-VGG input (BGR, 0..255, mean-subtracted),
    every operation in x's dtype (reference utils.py::vgg_preprocess)."""
    x = (x + 1.0) * 127.5
    x = x.flip(-1)
    return x - torch.tensor(_BGR_MEANS, dtype=x.dtype, device=x.device)


class Vgg16Features(nn.Module):
    """VGG16 trunk up to relu5_3 (reference networks.py::Vgg16): NHWC in
    any float dtype -> (B, H/16, W/16, 512) float32."""

    def __init__(self, device=None):
        super().__init__()
        in_ch = 3
        for item in _VGG16_PLAN:
            if item == "M":
                continue
            name, ch = item
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.zeros(ch, in_ch, 3, 3,
                                                   device=device))
            conv.bias = nn.Parameter(torch.zeros(ch, device=device))
            self.add_module(name, conv)
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        for item in _VGG16_PLAN:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv = getattr(self, item[0])
                x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
        return x.permute(0, 2, 3, 1)


def _instance_norm(f: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of NHWC f32 features: two-pass
    statistics over (H, W), the biased variance (``blocks.instance_norm``
    of the JAX package)."""
    mean, var = norm_mean_var(f, (1, 2), "two_pass")
    return (f - mean) * torch.rsqrt(var + eps)


def vgg_target_features(vgg: Vgg16Features, target: torch.Tensor
                        ) -> torch.Tensor:
    """The instance-normalized relu5_3 features of ``target``: what
    :func:`compute_vgg_loss` compares against."""
    return _instance_norm(vgg(vgg_preprocess(target)))


def compute_vgg_loss(vgg: Vgg16Features, img: torch.Tensor,
                     target: torch.Tensor,
                     target_features: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """MSE between instance-normalized relu5_3 features (reference trainer
    compute_vgg_loss). ``target_features``: :func:`vgg_target_features` of
    ``target``, when already computed (the same value)."""
    if target_features is None:
        target_features = vgg_target_features(vgg, target)
    return torch.mean((vgg_target_features(vgg, img) - target_features) ** 2)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def vgg_state_dict(weights: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The module's state dict (float32 ``convX_Y.weight`` OIHW and
    ``convX_Y.bias``) from the JAX ``.npz`` layout (``convX_Y/kernel`` HWIO,
    ``convX_Y/bias``), torchvision's ``features.N.*`` or ``convX_Y.*``;
    other keys are ignored. Raises unless exactly the 13 convs' 26 tensors
    are found."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in weights.items():
        arr = (val if isinstance(val, torch.Tensor) else
               torch.from_numpy(np.asarray(val))).detach().float().cpu()
        if "/" in key:                          # the JAX .npz layout
            layer, leaf = key.split("/", 1)
            if leaf == "kernel":
                out[f"{layer}.weight"] = arr.permute(3, 2, 0, 1).contiguous()
                continue
            if leaf == "bias":
                out[f"{layer}.bias"] = arr
            continue
        parts = key.split(".")
        if parts[0] == "features" and len(parts) == 3 and \
                parts[1].isdigit() and int(parts[1]) in _IDX2NAME:
            layer, leaf = _IDX2NAME[int(parts[1])], parts[2]
        elif parts[0].startswith("conv") and len(parts) == 2:
            layer, leaf = parts
        else:
            continue
        if leaf in ("weight", "bias"):
            out[f"{layer}.{leaf}"] = arr
    names = {f"{item[0]}.{leaf}" for item in _VGG16_PLAN if item != "M"
             for leaf in ("weight", "bias")}
    if len(out) != _N_TENSORS or set(out) != names:
        raise ValueError(f"expected {_N_TENSORS} tensors (13 convs), got "
                         f"{len(out)}")
    return out


def load_vgg_npz(path: str) -> Dict[str, torch.Tensor]:
    """The ``.npz`` of ``tools/convert_vgg_pt.py`` -> the module's state
    dict."""
    with np.load(path) as data:
        return vgg_state_dict({k: data[k] for k in data.files})


def save_vgg_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """The module's state dict -> the JAX package's flat ``.npz`` (HWIO
    kernels): the inverse of :func:`load_vgg_npz`."""
    flat = {}
    for key, t in state_dict.items():
        layer, leaf = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            flat[f"{layer}/kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        else:
            flat[f"{layer}/bias"] = arr
    np.savez(path, **flat)


def load_vgg(path: str, device="cuda") -> Vgg16Features:
    """A frozen :class:`Vgg16Features` on ``device`` from ``path``: a
    ``.npz`` (:func:`load_vgg_npz`) or a torch state dict file (a
    ``{"state_dict": ...}`` payload is unwrapped)."""
    if path.endswith(".npz"):
        sd = load_vgg_npz(path)
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = vgg_state_dict(obj.get("state_dict", obj))
    vgg = Vgg16Features(device=device)
    vgg.load_state_dict(sd, strict=True)
    return vgg.requires_grad_(False).eval()


def init_random_vgg(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights (tests and the card's smoke run only): each conv's
    kernel drawn from ``generator`` in plan order as flax's default
    ``lecun_normal``, biases 0, as the module's state dict."""
    init = make_kernel_init("default")
    vgg = Vgg16Features()
    out: Dict[str, torch.Tensor] = {}
    for name, p in vgg.state_dict().items():
        t = torch.zeros_like(p)
        if name.endswith("weight"):
            init(t, generator)
        out[name] = t
    return out
