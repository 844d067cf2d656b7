"""The port's in-training FID hook (``cfg.eval_iter``,
``councilx_torch/eval/hook.py``) on the CPU.

* On the same generator weights, eval rows, Inception ``.npz`` and the z
  codes the JAX hook draws (``PRNGKey(7)``, injected), its value is the
  JAX hook's within 1e-3 relative (f32 parity mode; a pixel may round to
  the other uint8 level);
* the train loop logs ``fid_a2b_m<k>`` for every member and ``fid_a2b``,
  their minimum, at the eval cadence;
* the hook draws nothing from the training z stream: a 2 + 2 resumed run
  with eval on is bitwise the 4-step run, and both end bitwise where the
  run without eval ends.

Every test swaps the FID for a cheap stand-in of the features, on both
sides where JAX runs (scipy's 2048x2048 ``sqrtm`` takes ~13 s on the CPU,
far more under a loaded test run); the FID code is equal to JAX's
(tests/test_torch_eval.py) and a real FID is held against JAX in
tests/test_torch_eval_cli.py.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx.config import Config as JConfig
from councilx.eval.hook import TrainEvalHook as JTrainEvalHook
from councilx.train.trainer import CouncilTrainer as JTrainer
from councilx.train.trainer import TrainState as JTrainState
from councilx_torch.ckpt import manager
from councilx_torch.ckpt.manager import params_to_state_dicts
from councilx_torch.cli import train as train_cli
from councilx_torch.config import Config
from councilx_torch.eval import hook, inception
from councilx_torch.train import loop
from councilx_torch.train.trainer import CouncilTrainer
from test_torch_train_helpers import raw_config

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.convert_inception_pt import convert  # noqa: E402

torch.set_num_threads(2)
TINY = {
    "image_save_iter": 0, "image_display_iter": 0, "display_size": 2,
    "snapshot_save_iter": 2, "log_iter": 1, "max_iter": 1000,
    "batch_size": 2, "compute_dtype": "float32", "num_workers": 2,
    "council": {"council_size": 2, "council_w": 0.2},
    "focus_loss": {"focus_enabled": True},
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
            "n_res": 1},
    "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
    "new_size": 36, "crop_image_height": 32, "crop_image_width": 32,
    "eval_inception_weights": "random", "eval_max_images": 3,
    "eval_member": "all",
}


def _mean_gap(f1, f2):
    """The loop tests' stand-in for the FID: the squared distance of the
    feature means."""
    return float(((f1.mean(0) - f2.mean(0)) ** 2).sum())


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("folders")
    r = np.random.default_rng(1)
    for split in ("trainA", "trainB", "testA", "testB"):
        os.makedirs(root / split)
        for i in range(5):
            Image.fromarray(r.integers(0, 256, (40, 38, 3), dtype=np.uint8)
                            ).save(root / split / f"{i}.jpg")
    return root


def _config_file(tmp_path, data_root, **over):
    path = tmp_path / "tiny.yaml"
    tmp_path.mkdir(exist_ok=True)
    path.write_text(yaml.safe_dump({**TINY, "data_root": str(data_root),
                                    **over}))
    return str(path)


def _logged(out):
    with open(os.path.join(out, "tiny", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    fids = {}
    for r in recs:
        vals = {k: v for k, v in r.items() if k.startswith("fid_")}
        if vals:
            fids[r["step"]] = vals
    return recs, fids


def test_hook_matches_the_jax_hook(tmp_path, monkeypatch):
    monkeypatch.setattr("councilx.eval.metrics.fid_from_features",
                        _mean_gap)
    monkeypatch.setattr(hook, "fid_from_features", _mean_gap)
    model = inception.init_random(inception.InceptionV3Features(
        device="cpu"), torch.Generator().manual_seed(3))
    weights = str(tmp_path / "inception.npz")
    np.savez(weights, **convert({k: v.numpy()
                                 for k, v in model.state_dict().items()}))
    raw = raw_config(eval_inception_weights=weights, eval_max_images=3,
                     eval_member=1, data={"new_size": 32})
    jcfg, cfg = JConfig.from_dict(raw), Config.from_dict(raw)
    jt = JTrainer(jcfg)
    # the generators alone: sample reads nothing else of the state
    gen = jax.device_get(jax.jit(jax.vmap(jt.gen.init, in_axes=(0, None)))(
        jax.random.split(jax.random.PRNGKey(0), 2),
        jnp.zeros((1, 32, 32, 3), jnp.float32))["params"])
    jstate = JTrainState(step=None, rng=None, params={"a2b": {"gen": gen}},
                         opt_gen=None, opt_dis=None, opt_cdis=None)
    r = np.random.default_rng(2)
    rows = {d: r.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
            for d in "ab"}
    loaders = [SimpleNamespace(head_rows=lambda n, d=d: rows[d][:n],
                               dataset=None) for d in "ab"]
    want = JTrainEvalHook(jcfg, jt, *loaders)(jt, jstate)

    trainer = CouncilTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    for g, sd in zip(state.gen["a2b"], params_to_state_dicts(gen, cfg),
                     strict=True):
        g.load_state_dict(sd)
    port = hook.TrainEvalHook(cfg, trainer, *loaders)
    # the JAX hook's fixed style draw, injected
    port._z["a2b"] = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (2, 3, cfg.gen.style_dim))))
    before = state.generator.get_state().clone()
    got = port(trainer, state)
    assert sorted(got) == sorted(want) == ["fid_a2b"]
    assert abs(got["fid_a2b"] - want["fid_a2b"]) <= 1e-3 * abs(
        want["fid_a2b"])
    assert torch.equal(state.generator.get_state(), before)


def test_hook_draws_its_own_fixed_z(monkeypatch):
    """Two calls on one state give the same values, the training z stream
    untouched; the z is seed 7's draw."""
    monkeypatch.setattr(hook, "fid_from_features", _mean_gap)
    cfg = Config.from_dict({**TINY, "new_size": 32})
    trainer = CouncilTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    r = np.random.default_rng(4)
    loaders = [SimpleNamespace(
        head_rows=lambda n, a=r.integers(0, 256, (5, 32, 32, 3),
                                         dtype=np.uint8): a[:n],
        dataset=None) for _ in "ab"]
    h = hook.TrainEvalHook(cfg, trainer, *loaders)
    assert torch.equal(h._z["a2b"], torch.randn(
        (2, 3, 3), generator=torch.Generator().manual_seed(hook.Z_SEED)))
    before = state.generator.get_state().clone()
    first, second = h(trainer, state), h(trainer, state)
    assert first == second
    assert sorted(first) == ["fid_a2b", "fid_a2b_m0", "fid_a2b_m1"]
    assert first["fid_a2b"] == min(first["fid_a2b_m0"], first["fid_a2b_m1"])
    assert torch.equal(state.generator.get_state(), before)


def test_loop_logs_every_member_and_the_minimum(tmp_path, data_root,
                                                monkeypatch):
    monkeypatch.setattr(hook, "fid_from_features", _mean_gap)
    cfg_path = _config_file(tmp_path, data_root, eval_iter=1)
    with pytest.warns(UserWarning, match="natively 38px"):
        train_cli.main(["--config", cfg_path, "--output_path",
                        str(tmp_path), "--max_steps", "2", "--device",
                        "cpu"])
    recs, fids = _logged(str(tmp_path))
    assert sorted(fids) == [1, 2]
    for step, vals in fids.items():
        assert sorted(vals) == ["fid_a2b", "fid_a2b_m0", "fid_a2b_m1"]
        assert all(np.isfinite(v) and v >= 0 for v in vals.values())
        assert vals["fid_a2b"] == min(vals["fid_a2b_m0"],
                                      vals["fid_a2b_m1"])
    # the step's metrics are logged first, then the FID
    steps = [r["step"] for r in recs]
    assert steps == [1, 1, 2, 2] and "loss_gen_total" in recs[0]


def test_resumed_run_with_eval_is_bitwise_the_uninterrupted_one(
        tmp_path, data_root, monkeypatch):
    monkeypatch.setattr(hook, "fid_from_features", _mean_gap)
    cfg_path = _config_file(tmp_path, data_root, eval_iter=2)
    plain_path = _config_file(tmp_path / "plain_cfg", data_root)
    runs = {k: str(tmp_path / k) for k in ("one", "two", "plain")}
    base = ["--device", "cpu", "--output_path"]
    train_cli.main(["--config", cfg_path, "--max_steps", "4"]
                   + base + [runs["one"]])
    train_cli.main(["--config", cfg_path, "--max_steps", "2"]
                   + base + [runs["two"]])
    s = train_cli.main(["--config", cfg_path, "--max_steps", "2",
                        "--resume"] + base + [runs["two"]])
    assert (s["start_step"], s["step"]) == (2, 4)
    train_cli.main(["--config", plain_path, "--max_steps", "4"]
                   + base + [runs["plain"]])

    def final(out):
        step, path = manager.latest_checkpoint(
            os.path.join(out, "tiny", "checkpoints"))
        return step, manager.load_snapshot(path)

    step_a, a = final(runs["one"])
    for other in ("two", "plain"):
        step_b, b = final(runs[other])
        assert step_a == step_b == 4
        for grp in ("params", "opt"):
            _assert_equal(a[grp], b[grp], grp)
        assert torch.equal(a["generator"], b["generator"]), other
    fids_one, fids_two = _logged(runs["one"])[1], _logged(runs["two"])[1]
    assert sorted(fids_one) == [2, 4] and fids_one == fids_two


def _assert_equal(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        for i, (u, v) in enumerate(zip(a, b, strict=True)):
            _assert_equal(u, v, f"{where}/{i}")
    else:
        assert torch.equal(a, b), where


def test_eval_needs_weights(tmp_path):
    cfg = Config.from_dict({**TINY, "eval_iter": 2,
                            "eval_inception_weights": ""})
    with pytest.raises(ValueError, match="eval_inception_weights"):
        loop.train(cfg, output_path=str(tmp_path), synthetic=True,
                   max_steps=2, device="cpu")


def test_make_inception_takes_random_weights_only_when_asked(capsys):
    """The weights rules the CLIs and the hook share: no weights raise
    unless random ones are allowed; random ones warn."""
    for weights in (None, ""):
        with pytest.raises(inception.MissingWeights):
            inception.make_inception(weights, "cpu")
    assert "random" not in capsys.readouterr().err
    a = inception.make_inception(None, "cpu", allow_random=True)
    assert "random Inception weights" in capsys.readouterr().err
    b = inception.make_inception("random", "cpu")
    assert "random Inception weights" in capsys.readouterr().err
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k


def test_random_weights_are_seed_0():
    a = inception.make_inception("random", "cpu")
    b = inception.init_random(inception.InceptionV3Features(device="cpu"),
                              torch.Generator().manual_seed(0))
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
