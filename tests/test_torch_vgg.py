"""councilx_torch's VGG16 perceptual loss (``nn/vgg.py``) and the trainer's
``vgg_w`` against the JAX package's (``councilx/nn/vgg.py``).

Random VGG16 weights from a ``torch.Generator`` (no download), written to
the JAX ``.npz`` layout and read by both packages. Inputs are 32px images
from a seeded numpy generator. Tolerances, each stated at its test:
the preprocess bit for bit (the same operations in the same dtype), the
f32 features and loss 1e-4 relative, the input gradient 1e-3 relative
(f32 convs summed in other orders), train steps as
tests/test_torch_train.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.config import Config as JConfig
from councilx.nn import vgg as jvgg
from councilx.train.trainer import CouncilTrainer as JTrainer
from councilx_torch.ckpt.manager import train_params_to_state_dicts
from councilx_torch.config import Config
from councilx_torch.nn import vgg
from councilx_torch.train.trainer import CouncilTrainer
from test_torch_train_helpers import (LR, Pair, assert_metrics_close, batch,
                                      max_param_diff, raw_config)

torch.set_num_threads(2)

# features, loss: f32 convs and reductions in other orders
REL = 1e-4
# the loss's input gradient: the same, through 13 convs backwards
GRAD_REL = 1e-3
# bf16 train steps: the rtol and atol of chip_smoke.py's phase 7 (card
# bf16 against CPU f32): each loss a mean over many bf16-rounded values
BF16_RTOL, BF16_ATOL = 3e-2, 1e-3


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(state dict, path of its .npz) of a seeded random VGG16."""
    sd = vgg.init_random_vgg(torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.npz")
    vgg.save_vgg_npz(path, sd)
    return sd, path


def _images(seed, b=2, hw=32):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg_preprocess_bit_equal(dtype):
    x = _images(1)
    want = np.asarray(jvgg.vgg_preprocess(jnp.asarray(x, dtype))
                      .astype(jnp.float32))
    got = vgg.vgg_preprocess(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _torchvision_layout(sd):
    """The state dict as torchvision's ``vgg16().features`` names it."""
    idx = {name: i for i, name in vgg._IDX2NAME.items()}
    return {f"features.{idx[k.split('.')[0]]}.{k.split('.')[1]}": v
            for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["npz", "torchvision", "convX_Y"])
def test_vgg_features_match_jax(weights, tmp_path, layout):
    """relu5_3 of every loader's module against flax's Vgg16Features on the
    same .npz, within REL of the features' largest value."""
    sd, npz = weights
    if layout == "npz":
        path = npz
    else:
        path = str(tmp_path / "vgg16.pth")
        torch.save({"state_dict": _torchvision_layout(sd)}
                   if layout == "torchvision" else sd, path)
    module = vgg.load_vgg(path, device="cpu")
    assert not any(p.requires_grad for p in module.parameters())
    for k, v in module.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = _images(2)
    want = np.asarray(jvgg.Vgg16Features().apply(
        {"params": jvgg.load_vgg_npz(npz)}, jnp.asarray(x)))
    got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


def test_vgg_loaders_refuse_a_partial_trunk(weights):
    sd, _ = weights
    part = {k: v for k, v in sd.items() if not k.startswith("conv5_3")}
    with pytest.raises(ValueError, match="26 tensors"):
        vgg.vgg_state_dict(part)
    with pytest.raises(ValueError, match="26 tensors"):
        vgg.vgg_state_dict({**_torchvision_layout(part), "classifier.0.weight":
                            torch.zeros(2, 2)})


def test_compute_vgg_loss_and_grad_match_jax(weights):
    sd, npz = weights
    params = jvgg.load_vgg_npz(npz)
    img, target = _images(3), _images(4)
    lj, gj = jax.value_and_grad(
        lambda a: jvgg.compute_vgg_loss(params, a, jnp.asarray(target)))(
        jnp.asarray(img))
    module = vgg.load_vgg(npz, device="cpu")
    x = torch.from_numpy(img).requires_grad_(True)
    t = torch.from_numpy(target)
    lp = vgg.compute_vgg_loss(module, x, t)
    (gp,) = torch.autograd.grad(lp, x)
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=REL)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gp.numpy(), gj, rtol=0,
                               atol=GRAD_REL * float(np.abs(gj).max()))
    # the target's features computed once give the same value
    with torch.no_grad():
        tf = vgg.vgg_target_features(module, t)
    assert torch.equal(vgg.compute_vgg_loss(module, x, t, tf), lp)


def _f32_zs(pair, js):
    """The JAX step's z draws as float32 numpy (bf16 draws are exact
    there; the port rounds them to its compute dtype again)."""
    zs = pair.jax_zs(js)
    return {k: {d: np.asarray(z, np.float32) for d, z in v.items()}
            for k, v in zs.items()}


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_vgg_train_steps_match_jax(weights, mode):
    """Two ``vgg_w: 1`` steps of both trainers from the same weights, batch
    and z: parity mode (f32) at tests/test_torch_train.py's tolerances;
    bf16 (the shipping modes) with every metric within BF16_RTOL /
    BF16_ATOL, as chip_smoke.py's phase 7 holds bf16 steps."""
    over = dict(vgg_w=1.0, vgg_model_path=weights[1])
    if mode == "bf16":
        over.update(parity_mode=False, compute_dtype="bfloat16")
    pair = Pair(**over)
    assert pair.jt.vgg_params is not None and pair.pt.vgg is not None
    x_a, x_b = batch()
    js, ps = pair.jax_state(), pair.port_state()
    jm, pm = [], []
    for _ in range(2):
        zs = _f32_zs(pair, js)
        js, m = pair.jt.train_step(js, jnp.asarray(x_a), jnp.asarray(x_b))
        jm.append({k: float(v) for k, v in jax.device_get(m).items()})
        ps, m = pair.pt.train_step(ps, x_a, x_b, zs=zs)
        pm.append({k: float(v) for k, v in m.items()})
    assert all(m["loss_gen_vgg_a2b"] > 0 for m in pm)
    if mode == "f32":
        assert_metrics_close(jm, pm, rtol=1e-5)
        want = train_params_to_state_dicts(jax.device_get(js.params),
                                           pair.cfg)
        assert max_param_diff(want, ps) <= 2 * LR * 2
        return
    for step, (a, b) in enumerate(zip(jm, pm)):
        assert set(a) == set(b)
        for k in a:
            assert abs(b[k] - a[k]) <= BF16_ATOL + BF16_RTOL * abs(a[k]), \
                (step + 1, k, b[k], a[k])


def test_missing_vgg_model_path_raises_on_both_sides():
    raw = raw_config(vgg_w=1.0)
    with pytest.raises(ValueError, match="vgg_model_path"):
        JTrainer(JConfig.from_dict(raw))
    with pytest.raises(ValueError, match="vgg_model_path"):
        CouncilTrainer(Config.from_dict(raw), device="cpu")
