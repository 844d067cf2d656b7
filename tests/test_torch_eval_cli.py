"""The port's eval CLI against the JAX package's, on the CPU.

A JAX council-2 generator (gen dim 8, 32px crops, f32) is exported with
``councilx.ckpt.manager.save_params_npz``, and random Inception weights
(the port's init, carried into the JAX layout by
``tools/convert_inception_pt.py::convert``) are written as the ``.npz`` both
packages load. With the z codes the JAX CLI draws (``cli/eval.py``: one
``jax.random.split`` per batch) put in place of the port's own draws, the
FIDs agree within 1e-3 relative (f32 translations may round a pixel to
the other uint8 level; the features then move by far less). The JSON key
sets of ``--member 0`` and ``--member all`` are the JAX CLI's. Past the
one FID held against JAX, the tests put a cheap stand-in in its place
(``_mean_gap``): each FID's 2048x2048 sqrtm takes ~13 s on a CPU.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx.ckpt.manager import save_params_npz as jsave_params_npz
from councilx.cli import eval as jeval_cli
from councilx.config import load_config as jload_config
from councilx.inference.translate import Translator as JTranslator
from councilx_torch.ckpt.manager import load_generator_state_dicts
from councilx_torch.cli import eval as eval_cli
from councilx_torch.config import load_config
from councilx_torch.data.dataset import ImageFolderDataset
from councilx_torch.eval import inception
from councilx_torch.eval.features import extract_features, folder_features
from councilx_torch.eval.metrics import fid_from_features
from councilx_torch.inference.translate import Translator

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.convert_inception_pt import convert  # noqa: E402

torch.set_num_threads(2)
TINY = {"batch_size": 2, "compute_dtype": "float32",
        "council": {"council_size": 2, "council_w": 0.2},
        "focus_loss": {"focus_enabled": True},
        "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
                "n_res": 2},
        "dis": {"dim": 8, "n_layer": 2, "num_scales": 1},
        "new_size": 36, "crop_image_height": 32, "crop_image_width": 32}
BATCH = 2
SEED = 1


def _write_folder(path, n, seed):
    os.makedirs(path)
    r = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(r.integers(0, 256, (40, 38 + i, 3), dtype=np.uint8)
                        ).save(os.path.join(path, f"img_{i}.png"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evalcli")
    cfg_path = str(tmp / "tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(TINY, f)
    jtr = JTranslator(jload_config(cfg_path))
    stacked = jax.device_get(jax.jit(jax.vmap(jtr.gen.init,
                                              in_axes=(0, None)))(
        jax.random.split(jax.random.PRNGKey(0), 2),
        jnp.zeros((1, 32, 32, 3), jnp.float32))["params"])
    gen = str(tmp / "gen.npz")
    jsave_params_npz(gen, stacked)
    model = inception.init_random(inception.InceptionV3Features(
        device="cpu"), torch.Generator().manual_seed(0))
    weights = str(tmp / "inception.npz")
    np.savez(weights, **convert({k: v.numpy()
                                 for k, v in model.state_dict().items()}))
    inp, tgt = str(tmp / "testA"), str(tmp / "testB")
    _write_folder(inp, 5, seed=0)   # 5 images at batch 2: a padded tail
    _write_folder(tgt, 6, seed=1)
    return cfg_path, gen, weights, inp, tgt


def _args(setup, member):
    cfg_path, gen, weights, inp, tgt = setup
    return ["--config", cfg_path, "--checkpoint", gen, "--input_folder", inp,
            "--target_folder", tgt, "--weights", weights, "--kid",
            "--kid-subset-size", "4", "--member", member, "--batch_size",
            str(BATCH), "--feature_batch_size", str(BATCH), "--seed",
            str(SEED)]


def _jax_zs(shape_of_batch, n_batches):
    """The z codes the JAX CLI draws: one split of PRNGKey(seed) per
    batch."""
    rng, out = jax.random.PRNGKey(SEED), []
    for _ in range(n_batches):
        rng, k = jax.random.split(rng)
        out.append(torch.from_numpy(np.asarray(
            jax.random.normal(k, shape_of_batch))))
    return out


class _WithZs:
    """The port's Translator with the given z codes in place of its own
    draws: each translate call takes the next."""

    def __init__(self, translator, zs):
        self.translator, self.zs = translator, iter(zs)

    def translate_u8(self, gens, x, z=None, rng=None, member=None):
        return self.translator.translate_u8(gens, x, z=next(self.zs),
                                            member=member)

    def translate_all_members(self, gens, x, z=None, rng=None):
        return self.translator.translate_all_members(gens, x,
                                                     z=next(self.zs))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _mean_gap(f1, f2):
    """A cheap stand-in for the FID (scipy's 2048x2048 sqrtm takes ~13 s
    on the CPU): the squared distance of the feature means. The FID of
    ``--member 0`` is held against JAX as it is; ``--member all`` (two
    more per side) is held with this in place of the FID on both sides,
    the metric's code being equal to JAX's (tests/test_torch_eval.py)."""
    return float(((f1.mean(0) - f2.mean(0)) ** 2).sum())


_JAX_OUT = {}


def _jax_out(setup, member):
    """The JAX CLI's JSON for ``member``, run once per module (with
    ``--member all``, on the stand-in)."""
    if member not in _JAX_OUT:
        with pytest.MonkeyPatch.context() as mp:
            if member == "all":
                mp.setattr("councilx.eval.metrics.fid_from_features",
                           _mean_gap)
            _JAX_OUT[member] = jeval_cli.main(_args(setup, member))
    return _JAX_OUT[member]


@pytest.mark.parametrize("member", ["0", "all"])
def test_eval_matches_the_jax_cli_with_its_z(setup, member, capsys):
    cfg_path, gen, weights, inp, tgt = setup
    want = _jax_out(setup, member)
    cfg = load_config(cfg_path)
    tr = Translator(cfg, device="cpu")
    gens = tr.load_members(load_generator_state_dicts(gen, cfg))
    model = inception.load_weights(
        inception.InceptionV3Features(device="cpu"), weights)
    ds = ImageFolderDataset(inp, new_size=cfg.data.new_size,
                            crop=cfg.data.crop_image_height)
    n_batches = -(-len(ds) // BATCH)
    f_target = folder_features(tgt, model, BATCH)
    if member == "all":
        zs = _jax_zs((2, BATCH, cfg.gen.style_dim), n_batches)
        feats = eval_cli.per_member_features(_WithZs(tr, zs), gens, ds, None,
                                             BATCH, model)
        fids = [_mean_gap(f, f_target) for f in feats]
        assert len(fids) == len(want["fid_per_member"]) == 2
        for got, w in zip(fids, want["fid_per_member"]):
            assert _rel(got, w) <= 1e-3, (fids, want)
    else:
        zs = _jax_zs((BATCH, cfg.gen.style_dim), n_batches)
        f = extract_features(model, eval_cli.translated_feature_batches(
            _WithZs(tr, zs), gens, ds, 0, None, BATCH), pad_batch=BATCH)
        assert f.shape == (5, 2048)
        assert _rel(fid_from_features(f, f_target), want["fid"]) <= 1e-3


def test_eval_all_prints_the_jax_keys_and_saves(setup, tmp_path, capsys,
                                                monkeypatch):
    """``--member all``: the JAX CLI's keys in one JSON line, the argmin
    as the best member, its KID as ``kid``, and every member's
    translations saved."""
    want = _jax_out(setup, "all")
    capsys.readouterr()
    monkeypatch.setattr("councilx_torch.eval.metrics.fid_from_features",
                        _mean_gap)
    save = str(tmp_path / "saved")
    out = eval_cli.main(_args(setup, "all") + ["--device", "cpu",
                                               "--save_translations", save])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    assert sorted(out) == sorted(want)
    assert (out["n_translated"], out["n_target"]) == (5, 6)
    assert out["best_member"] == int(np.argmin(out["fid_per_member"]))
    assert out["fid"] == min(out["fid_per_member"])
    assert out["kid"] == out["kid_per_member"][out["best_member"]]
    assert sorted(os.listdir(save)) == ["m0", "m1"]
    for m in ("m0", "m1"):
        names = sorted(os.listdir(os.path.join(save, m)))
        assert names == [f"img_{i}.png" for i in range(5)]
        with Image.open(os.path.join(save, m, names[0])) as img:
            assert img.size == (32, 32)


def test_eval_member_0_with_random_weights(setup, capsys, monkeypatch):
    """``--member 0`` prints the JAX CLI's keys; without ``--weights`` it
    refuses unless ``--allow-random`` is given, and then warns."""
    want = _jax_out(setup, "0")
    capsys.readouterr()
    monkeypatch.setattr("councilx_torch.eval.metrics.fid_from_features",
                        _mean_gap)
    args = _args(setup, "0") + ["--device", "cpu"]
    i = args.index("--weights")
    del args[i:i + 2]
    with pytest.raises(SystemExit):
        eval_cli.main(args)
    out = eval_cli.main(args + ["--allow-random"])
    captured = capsys.readouterr()
    assert "random Inception weights" in captured.err
    line = [ln for ln in captured.out.splitlines() if ln.startswith("{")][-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    assert sorted(out) == sorted(want)
    assert (out["n_translated"], out["n_target"], out["member"]) == (5, 6, 0)
    assert np.isfinite(out["fid"]) and out["fid"] >= 0
    assert len(out["kid"]) == 2 and np.isfinite(out["kid"]).all()


def test_eval_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        eval_cli.main(_args(setup, "0"))
