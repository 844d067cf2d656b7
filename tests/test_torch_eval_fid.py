"""The port's folder FID CLI and reference-checkpoint convert CLI against
the JAX package's, on the CPU: ``cli/fid.py`` prints ``tools/fid.py``'s
keys and agrees with it within 1e-3 relative on the same Inception
``.npz`` (the same PIL inputs; only the f32 features' summation order
differs; a stand-in of the features in the FID's place on both sides, its
KID real); ``cli/convert.py`` writes the same arrays as
``councilx.cli.convert`` from the same reference ``.pt``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx.cli import convert as jconvert_cli
from councilx_torch.ckpt.manager import load_generator_state_dicts
from councilx_torch.cli import convert as convert_cli
from councilx_torch.cli import fid as fid_cli
from councilx_torch.config import load_config
from councilx_torch.eval import inception
from councilx_torch.inference.translate import Translator

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import fid as jfid_tool  # noqa: E402
from tools.convert_inception_pt import convert  # noqa: E402

torch.set_num_threads(2)
TINY = {"compute_dtype": "float32",
        "council": {"council_size": 2, "council_w": 0.2},
        "focus_loss": {"focus_enabled": True},
        "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
                "n_res": 2},
        "new_size": 36, "crop_image_height": 32, "crop_image_width": 32}
BATCH = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fidcli")
    cfg_path = str(tmp / "tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(TINY, f)
    model = inception.init_random(inception.InceptionV3Features(
        device="cpu"), torch.Generator().manual_seed(0))
    weights = str(tmp / "inception.npz")
    np.savez(weights, **convert({k: v.numpy()
                                 for k, v in model.state_dict().items()}))
    r = np.random.default_rng(0)
    folders = []
    for name, n in (("a", 5), ("b", 6)):
        path = tmp / name
        path.mkdir()
        for i in range(n):
            Image.fromarray(r.integers(0, 256, (40, 38 + i, 3),
                                       dtype=np.uint8)
                            ).save(path / f"img_{i}.png")
        folders.append(str(path))
    return cfg_path, weights, folders


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _mean_gap(f1, f2):
    """A cheap stand-in for the FID on both sides (each FID's 2048x2048
    scipy sqrtm takes ~13 s on the CPU, far more under a loaded test run;
    the FID code is equal to JAX's, tests/test_torch_eval.py, and a real
    one is held against JAX in tests/test_torch_eval_cli.py): the squared
    distance of the feature means."""
    return float(((f1.mean(0) - f2.mean(0)) ** 2).sum())


def test_fid_cli_matches_tools_fid(setup, monkeypatch, capsys):
    _, weights, (inp, tgt) = setup
    monkeypatch.setattr("councilx.eval.metrics.fid_from_features",
                        _mean_gap)
    monkeypatch.setattr("councilx_torch.eval.metrics.fid_from_features",
                        _mean_gap)
    args = [inp, tgt, "--weights", weights, "--kid", "--kid-subset-size",
            "4", "--batch-size", str(BATCH)]
    monkeypatch.setattr(sys, "argv", ["fid.py"] + args)
    jfid_tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = fid_cli.main(args + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(got))
    assert sorted(got) == sorted(want)
    assert (got["n_a"], got["n_b"]) == (want["n_a"], want["n_b"]) == (5, 6)
    # the same PIL inputs: only the f32 features' summation order differs
    assert _rel(got["fid"], want["fid"]) <= 1e-3
    assert abs(got["kid_mean"] - want["kid_mean"]) <= 1e-3 * max(
        abs(want["kid_mean"]), want["kid_std"], 1e-6)


def test_convert_writes_the_jax_cli_arrays(setup, tmp_path, monkeypatch):
    cfg_path = setup[0]
    cfg = load_config(cfg_path)
    gens = Translator(cfg, device="cpu").init_members(2, seed=3)
    pt = str(tmp_path / "gen_00000010.pt")
    torch.save({f"a2b_{i}": g.state_dict() for i, g in enumerate(gens)}, pt)
    want_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["convert", "--pt", pt, "--config",
                                      cfg_path, "--out", want_path])
    jconvert_cli.main()
    convert_cli.main(["--pt", pt, "--config", cfg_path, "--out", got_path])
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the .npz loads back into the same members
    back = load_generator_state_dicts(got_path, cfg)
    for g, sd in zip(gens, back):
        for k, v in g.state_dict().items():
            assert torch.equal(sd[k], v), k


def test_fid_refuses_random_weights_unless_allowed(setup):
    _, _, (inp, tgt) = setup
    with pytest.raises(SystemExit):
        fid_cli.main([inp, tgt, "--device", "cpu"])


def test_fid_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, weights, (inp, tgt) = setup
    with pytest.raises((AssertionError, RuntimeError)):
        fid_cli.main([inp, tgt, "--weights", weights])
