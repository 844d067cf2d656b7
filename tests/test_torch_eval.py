"""The port's FID/KID metrics, InceptionV3 features and feature
preprocessing against the JAX package's, on the CPU.

* metrics: the same numpy/scipy code, so FID and KID on the same features
  equal the JAX package's to 1e-10 (KID draws the same subsets);
* InceptionV3Features at 96px (``resize_input=False``), in f32, both
  ``fid_variant`` values, within rtol 1e-4 of flax (atol 1e-4 of the
  largest feature, for features near zero): JAX-layout weights with every
  leaf drawn from a numpy seed (BatchNorm scale, bias, mean and var too, so
  the BN mapping and the kernel transposes are exercised — the 1x7/7x1
  pairs catch an H/W swap) carried across through the ``.npz``; and the
  port's torchvision-named state dict through
  ``tools/convert_inception_pt.py::convert`` into flax;
* the resize to 299, enlarging and shrinking, against ``jax.image.resize``;
* ``u8_to_inception_inputs`` and ``iter_image_batches`` bit-equal to the
  JAX package's; ``extract_features`` drops the padding rows.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from councilx.eval import features as jfeatures
from councilx.eval import metrics as jmetrics
from councilx.eval.inception import InceptionV3Features as JInception
from councilx.eval.inception import load_params_npz as jload_params_npz
from councilx_torch.eval import features, inception, metrics
from councilx_torch.eval.inception import InceptionV3Features

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.convert_inception_pt import convert  # noqa: E402

torch.set_num_threads(2)
HW = 96


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

def _closed_form(case):
    """(mu1, s1, mu2, s2, FID) of the JAX package's closed-form cases."""
    if case == "identical":
        f = np.random.RandomState(0).randn(500, 16)
        mu, s = jmetrics.gaussian_stats(f)
        return mu, s, mu, s, 0.0
    if case == "mean_shift":
        f = np.random.RandomState(1).randn(2000, 8)
        mu, s = jmetrics.gaussian_stats(f)
        shift = np.full(8, 0.5)
        return mu, s, mu + shift, s, float(shift @ shift)
    d = 6
    s1 = np.diag(np.linspace(1.0, 2.0, d))
    s2 = np.diag(np.linspace(0.5, 1.5, d))
    want = 0.09 * d + np.sum((np.sqrt(np.diag(s1))
                              - np.sqrt(np.diag(s2))) ** 2)
    return np.zeros(d), s1, np.ones(d) * 0.3, s2, want


@pytest.mark.parametrize("case", ["identical", "mean_shift", "diagonal"])
def test_frechet_distance_closed_forms_equal_jax(case):
    mu1, s1, mu2, s2, want = _closed_form(case)
    got = metrics.frechet_distance(mu1, s1, mu2, s2)
    assert abs(got - jmetrics.frechet_distance(mu1, s1, mu2, s2)) <= 1e-10
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("n,d", [(40, 8), (12, 64)])
def test_fid_and_kid_equal_jax(n, d):
    """Full-rank and singular (n < d) covariances; KID's subsets are the
    same RandomState draws, so its mean and std are equal."""
    r = np.random.RandomState(5)
    a = r.randn(n, d).astype(np.float32)
    b = (r.randn(n + 3, d) * 1.3 + 0.2).astype(np.float32)
    assert abs(metrics.fid_from_features(a, b)
               - jmetrics.fid_from_features(a, b)) <= 1e-10
    mu, s = metrics.gaussian_stats(a)
    jmu, js = jmetrics.gaussian_stats(a)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(s, js)
    got = metrics.kid_from_features(a, b, n_subsets=7, subset_size=10,
                                    seed=3)
    want = jmetrics.kid_from_features(a, b, n_subsets=7, subset_size=10,
                                      seed=3)
    assert np.abs(np.subtract(got, want)).max() <= 1e-10


def test_kid_needs_two_samples():
    with pytest.raises(ValueError, match="at least 2"):
        metrics.kid_from_features(np.zeros((1, 4)), np.zeros((5, 4)))


# ----------------------------------------------------------------------
# InceptionV3 features
# ----------------------------------------------------------------------

_JAPPLY = {}


def _japply(fid_variant):
    """flax's apply at 96px without the resize, jitted once per variant
    (the variables are an argument, so new weights do not recompile)."""
    if fid_variant not in _JAPPLY:
        _JAPPLY[fid_variant] = jax.jit(JInception(
            fid_variant=fid_variant, resize_input=False).apply)
    return _JAPPLY[fid_variant]


def _x(seed=0, b=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (b, HW, HW, 3)).astype(np.float32)


def _assert_features_close(got, want):
    assert got.shape == want.shape == (2, 2048)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _seeded_jax_variables(fid_variant, seed):
    """Every leaf of the flax variables drawn from a numpy seed at the
    shapes flax's own init gives (traced abstractly, no compute): kernels
    He-normal, BN scale and var in [0.5, 1.5], bias and mean ~N(0, 0.1)."""
    shapes = jax.eval_shape(
        JInception(fid_variant=fid_variant, resize_input=False).init,
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3), jnp.float32))
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(s.shape[:3])
            return (r.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        if name in ("scale", "var"):
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (r.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("fid_variant", [True, False])
def test_inception_from_jax_npz_matches_flax(tmp_path, fid_variant):
    variables = _seeded_jax_variables(fid_variant, seed=1)
    npz = str(tmp_path / "inception.npz")
    np.savez(npz, **_flatten(variables))
    x = _x()
    want = np.asarray(_japply(fid_variant)(jload_params_npz(npz), x))
    model = inception.load_weights(InceptionV3Features(
        fid_variant=fid_variant, resize_input=False, device="cpu"), npz)
    _assert_features_close(model(torch.from_numpy(x)).numpy(), want)


def _perturbed_port_model(fid_variant, seed):
    """The port's random init with every BatchNorm's scale, bias, mean and
    var replaced by seeded values."""
    model = inception.init_random(InceptionV3Features(
        fid_variant=fid_variant, resize_input=False, device="cpu"),
        torch.Generator().manual_seed(seed))
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.weight.copy_(torch.from_numpy(r.uniform(0.5, 1.5, n)))
                mod.bias.copy_(torch.from_numpy(r.normal(0, 0.1, n)))
                mod.running_mean.copy_(torch.from_numpy(r.normal(0, 0.1, n)))
                mod.running_var.copy_(torch.from_numpy(r.uniform(0.5, 1.5,
                                                                 n)))
    return model


def _unflatten(flat):
    tree = {}
    for key, val in flat.items():
        *scope, leaf = key.split("/")
        node = tree
        for p in scope:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


@pytest.mark.parametrize("fid_variant", [True, False])
def test_torchvision_state_dict_through_the_converter_matches_flax(
        fid_variant):
    model = _perturbed_port_model(fid_variant, seed=2)
    sd = model.state_dict()
    # torchvision names: the backbone, plus what the converter drops
    assert "Mixed_5b.branch1x1.conv.weight" in sd
    assert "Mixed_7c.branch3x3dbl_3b.bn.running_var" in sd
    sd = {**sd, "fc.weight": torch.zeros(1000, 2048),
          "AuxLogits.fc.bias": torch.zeros(1000)}
    flat = convert({k: v.numpy() for k, v in sd.items()})
    x = _x(seed=3)
    want = np.asarray(_japply(fid_variant)(_unflatten(flat), x))
    _assert_features_close(model(torch.from_numpy(x)).numpy(), want)
    # and the converter's output carried back is the same state dict
    back = inception.state_dict_from_npz(flat)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_load_weights_takes_torchvision_and_pytorch_fid_files(tmp_path):
    """A .pth state dict with the classifier head and AuxLogits, and one
    without ``num_batches_tracked`` (load strict after both are
    handled)."""
    model = _perturbed_port_model(True, seed=4)
    sd = dict(model.state_dict())
    full = {**sd, "fc.weight": torch.ones(1008, 2048),
            "fc.bias": torch.ones(1008),
            "AuxLogits.conv0.conv.weight": torch.ones(128, 768, 1, 1)}
    bare = {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    x = torch.from_numpy(_x(seed=5))
    want = model(x)
    for name, obj in (("full.pth", full), ("bare.pt", {"state_dict": bare})):
        torch.save(obj, tmp_path / name)
        got = inception.load_weights(InceptionV3Features(
            resize_input=False, device="cpu"), str(tmp_path / name))
        assert torch.equal(got(x), want), name


def test_state_dict_from_npz_rejects_unknown_tensors():
    with pytest.raises(ValueError, match="unrecognized"):
        inception.state_dict_from_npz({"params/Mixed_5b/fc/weight":
                                       np.zeros(3)})


def test_parameter_count_is_the_torchvision_backbone():
    model = InceptionV3Features(device="cpu")
    # torchvision inception_v3 has 27,161,264 parameters; less fc
    # (2,049,000) and AuxLogits (3,326,696)
    assert sum(p.numel() for p in model.parameters()) == 21_785_568


def test_inception_defaults_to_the_card():
    if torch.cuda.is_available():
        assert InceptionV3Features().device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        InceptionV3Features()


def test_tf32_off_restores_the_settings():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with inception.tf32_off():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.backends.cuda.matmul.allow_tf32 = before[1]


@pytest.mark.parametrize("hw", [(64, 80), (400, 350)])
def test_resize_to_299_matches_jax(hw):
    """Enlarging (plain bilinear) and shrinking (antialiased, the triangle
    kernel that jax.image.resize's scale_and_translate computes), as the
    module's ``resize_input`` runs it. atol 1e-5: both compute the tap
    positions (i + 0.5) * in / 299 - 0.5 in f32; enlarging 64 -> 299 each
    is up to 1.4e-5 from the float64 bilinear and 6.7e-6 from the other,
    far under what moves a feature by 1e-4."""
    x = np.random.default_rng(6).uniform(-1, 1, (2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       "bilinear"))
    got = inception.resize_bilinear(torch.from_numpy(x), 299, 299).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# preprocessing and batching
# ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [299, 96])
def test_u8_to_inception_inputs_is_bit_equal(size):
    u8 = np.random.default_rng(7).integers(0, 256, (3, 37, 52, 3),
                                           dtype=np.uint8)
    got = features.u8_to_inception_inputs(u8, size)
    assert got.dtype == np.float32 and got.shape == (3, size, size, 3)
    np.testing.assert_array_equal(got,
                                  jfeatures.u8_to_inception_inputs(u8, size))


def test_iter_image_batches_is_bit_equal(tmp_path):
    r = np.random.default_rng(8)
    (tmp_path / "sub").mkdir()
    for i in range(7):
        d = tmp_path / ("sub" if i % 3 == 0 else "")
        Image.fromarray(r.integers(0, 256, (30 + i, 41, 3), dtype=np.uint8)
                        ).save(d / f"im{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    got = list(features.iter_image_batches(str(tmp_path), 3, 64))
    want = list(jfeatures.iter_image_batches(str(tmp_path), 3, 64))
    assert [b.shape[0] for b in got] == [3, 3, 1]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        list(features.iter_image_batches(str(tmp_path / "sub" / "none")))


class _MeanFeatures(torch.nn.Module):
    """(B,H,W,3) -> (B,3) channel means; records the batch sizes it
    sees."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.seen = []

    def forward(self, x):
        self.seen.append(x.shape[0])
        return x.mean(dim=(1, 2)) * self.w


def test_extract_features_pads_the_tail_and_drops_it():
    r = np.random.default_rng(9)
    batches = [r.standard_normal((4, 5, 5, 3)).astype(np.float32),
               r.standard_normal((1, 5, 5, 3)).astype(np.float32)]
    fn = _MeanFeatures()
    got = features.extract_features(fn, batches, pad_batch=4)
    assert fn.seen == [4, 4] and got.shape == (5, 3)
    want = jfeatures.extract_features(lambda x: x.mean(axis=(1, 2)),
                                      batches, pad_batch=4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    fn.seen.clear()
    assert features.extract_features(fn, batches).shape == (5, 3)
    assert fn.seen == [4, 1]
