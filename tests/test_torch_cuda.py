"""councilx_torch's kernels and serving path on an NVIDIA GPU.

Every test here needs a card and skips without one. The file imports
neither JAX nor ``councilx``, so it also runs on a GPU machine without JAX,
where tests/conftest.py (which imports JAX) must be left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from councilx_torch.config import load_config
from councilx_torch.inference.translate import Translator
from councilx_torch.ops.conv3x3 import conv3x3_valid, conv3x3_valid_reference
from councilx_torch.ops.instance_norm import (instance_norm,
                                              instance_norm_reference)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,o", [(2, 64, 64, 256, 256),
                                       (1, 5, 7, 16, 24), (3, 9, 3, 8, 136)])
def test_conv3x3_kernel_matches_plain(cuda, dtype, b, h, w, c, o):
    g = torch.Generator(device=cuda).manual_seed(0)
    xp = torch.randn(b, h + 2, w + 2, c, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, c, o, device=cuda, generator=g)
         / (9 * c) ** 0.5).to(dtype)
    before = conv3x3_valid.launches
    got = conv3x3_valid(xp, k).float()
    torch.cuda.synchronize()
    assert conv3x3_valid.launches == before + 1
    want = conv3x3_valid_reference(xp.float(), k.float())
    # bf16: one rounding of the f32 sum (a bf16 step is 2**-8 relative);
    # f32: sums of 9*C terms in another order
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * \
        want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 64, 64, 256), (2, 32, 32, 64),
                                   (2, 5, 7, 24)])
@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_kernel_matches_plain(cuda, dtype, shape, affine):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(*shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    args = ()
    if affine:
        args = (torch.randn(shape[0], shape[3], device=cuda, generator=g),
                torch.randn(shape[0], shape[3], device=cuda, generator=g))
    got = instance_norm(x, *args).float()
    want = instance_norm_reference(x, *args).float()
    # bf16: both sides round once from f32 and may differ by a step at the
    # largest magnitude; f32: sums over HW in another order
    tol = (2 ** -6 if dtype == torch.bfloat16 else 1e-5) * \
        want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 6, 6, 12, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3_valid(x, torch.zeros(3, 3, 12, 8, device=cuda))
    x = torch.zeros(1, 6, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_valid(x.transpose(1, 2), torch.zeros(3, 3, 8, 8,
                                                     device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        instance_norm(x.half())


def test_translate_on_gpu_matches_cpu_and_runs_the_kernels(cuda):
    # smoke_tiny: f32, dim 8 (content 32 channels), n_res 2, 32px
    cfg = load_config(os.path.join(REPO, "configs", "smoke_tiny.yaml"))
    sds = [{k: v.cpu() for k, v in g.state_dict().items()}
           for g in Translator(cfg).init_members(2, seed=0)]
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    z = r.standard_normal((3, 3)).astype(np.float32)
    cpu = Translator(cfg)
    want = cpu.translate(cpu.load_members(sds), x, z=z, member=1)[0]
    gpu = Translator(cfg, device=cuda)
    gens = gpu.load_members(sds)
    conv0, norm0 = conv3x3_valid.launches, instance_norm.launches
    got = gpu.translate(gens, x, z=z, member=1)[0].cpu()
    # per member forward: 2 resblocks x 2 convs in the encoder and the
    # decoder; 7 IN (7x7, two downsamples, 4 resblock convs) + 4 AdaIN
    assert conv3x3_valid.launches - conv0 == 8
    assert instance_norm.launches - norm0 == 11
    # f32 through ~20 layers, TF32 off, sums in another order
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
