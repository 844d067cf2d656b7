"""councilx_torch kernel sites vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; those are held
against the JAX Pallas functions run in interpret mode, as
tests/test_pallas_conv.py and tests/test_pallas_norm.py run them. The
kernels themselves run only on a GPU: tests/test_torch_cuda.py compares
each with its plain version there.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from councilx.ops.pallas_conv import conv3x3_valid as jax_conv3x3_valid
from councilx.ops.pallas_norm import instance_norm_pallas
from councilx_torch.ops.conv3x3 import conv3x3_valid, conv3x3_valid_reference
from councilx_torch.ops.instance_norm import (instance_norm,
                                              instance_norm_reference)

torch.set_num_threads(2)


def _interp(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        with pltpu.force_tpu_interpret_mode():
            return fn(*args, **kw)
    return run


# ---------------------------------------------------------------------------
# plain versions vs the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 16, 8, 256)])
def test_conv3x3_reference_matches_pallas(shape):
    r = np.random.default_rng(0)
    b, h, w, c = shape
    xp = r.standard_normal((b, h + 2, w + 2, c)).astype(np.float32)
    k = (r.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    want = np.asarray(_interp(jax_conv3x3_valid)(jnp.asarray(xp),
                                                 jnp.asarray(k)))
    got = conv3x3_valid_reference(torch.from_numpy(xp), torch.from_numpy(k))
    # f32 sums of 9*C products in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 8),
                                   (3, 16, 16, 32)])
def test_instance_norm_reference_matches_pallas(shape):
    r = np.random.default_rng(0)
    x = (r.standard_normal(shape) * 3 + 1).astype(np.float32)
    want = np.asarray(_interp(instance_norm_pallas)(jnp.asarray(x)))
    got = instance_norm_reference(torch.from_numpy(x))
    # f32 statistics, summed in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_adain_reference_matches_pallas():
    r = np.random.default_rng(1)
    b, h, w, c = 2, 6, 6, 16
    x = r.standard_normal((b, h, w, c)).astype(np.float32)
    g = r.standard_normal((b, c)).astype(np.float32)
    bt = r.standard_normal((b, c)).astype(np.float32)
    want = np.asarray(_interp(instance_norm_pallas)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(bt)))
    got = instance_norm_reference(torch.from_numpy(x), torch.from_numpy(g),
                                  torch.from_numpy(bt))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_reference_bf16_input_matches_pallas(affine):
    r = np.random.default_rng(2)
    b, h, w, c = 2, 8, 8, 16
    x = (r.standard_normal((b, h, w, c)) * 3 + 1).astype(np.float32)
    g = r.standard_normal((b, c)).astype(np.float32)
    bt = r.standard_normal((b, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if affine:
        want = _interp(instance_norm_pallas)(xj, jnp.asarray(g),
                                             jnp.asarray(bt))
        got = instance_norm_reference(xt, torch.from_numpy(g),
                                      torch.from_numpy(bt))
    else:
        want = _interp(instance_norm_pallas)(xj)
        got = instance_norm_reference(xt)
    assert got.dtype == torch.bfloat16
    # both take f32 statistics of the same bf16 input and round once to
    # bf16; |y| stays below ~8 here, where a bf16 step is at most 0.03
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.06)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    r = np.random.default_rng(3)
    xp = torch.from_numpy(r.standard_normal((1, 6, 7, 8)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((3, 3, 8, 16)).astype(np.float32))
    x = torch.from_numpy(r.standard_normal((2, 4, 4, 8)).astype(np.float32))
    g = torch.ones(2, 8)
    conv0, norm0 = conv3x3_valid.launches, instance_norm.launches
    assert torch.equal(conv3x3_valid(xp, k), conv3x3_valid_reference(xp, k))
    assert torch.equal(instance_norm(x), instance_norm_reference(x))
    assert torch.equal(instance_norm(x, g, g),
                       instance_norm_reference(x, g, g))
    assert (conv3x3_valid.launches, instance_norm.launches) == (conv0, norm0)
    with pytest.raises(ValueError, match="together"):
        instance_norm(x, g, None)


@pytest.mark.parametrize("header", ["common.cuh", "tiles.h"])
def test_kernel_build_is_named_by_its_headers_too(tmp_path, monkeypatch,
                                                  header):
    """An edited header in csrc/ gives the library a new name, so a stale
    build is never loaded for it; the flags and the source do too."""
    from councilx_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / header).write_text("constexpr int TILE = 128;\n")
    first = _build._library_path("k")
    assert first == _build._library_path("k")
    (tmp_path / header).write_text("constexpr int TILE = 64;\n")
    second = _build._library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._library_path("k") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._library_path("k") not in (first, second)
    assert os.path.dirname(first) == str(tmp_path / "build")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hwio_weight_is_the_kernel_weight_without_a_copy(dtype):
    """The blocks' k: the OIHW weight as HWIO in the compute dtype, laid out
    so that the conv kernels' weight is k's own storage (the forward and
    the dgrad copy nothing), and the gradient reaches the OIHW weight."""
    from councilx_torch.ops.conv3x3 import _kernel_weight, hwio_weight

    r = np.random.default_rng(4)
    w = torch.from_numpy(r.standard_normal((16, 8, 3, 3)).astype(np.float32))
    w.requires_grad_()
    k = hwio_weight(w, dtype)
    assert k.dtype == dtype and k.shape == (3, 3, 8, 16)
    assert torch.equal(k, w.detach().permute(2, 3, 1, 0).to(dtype))
    wk = _kernel_weight(k, dtype)
    assert wk.shape == (3, 3, 16, 8) and wk.data_ptr() == k.data_ptr()
    k.float().sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
