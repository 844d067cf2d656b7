"""``python -m councilx_torch.tools.export_pt``: a port training snapshot ->
reference-layout ``gen_/dis_/dis_council_<step>.pt`` files.

One port trainer (the tiny config of tests/test_torch_train_helpers.py,
both directions, on the CPU) takes a step and snapshots it. The export must
name its files by the step and key them ``"<direction>_<i>"``; hold every
tensor equal (atol 0) to what the JAX package's exporters
(``councilx.ckpt.torch_export.export_adain_gen`` / ``export_ms_image_dis``)
write for the same weights carried into JAX trees (the JAX package's
``torch_convert``); and give the snapshot's tensors back through the port's
``extract_member_state_dicts`` and its ``.pt`` loader.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from councilx.ckpt import torch_convert as jconvert
from councilx.ckpt import torch_export as jexport
from councilx_torch.ckpt.manager import (load_generator_state_dicts,
                                         save_checkpoint)
from councilx_torch.ckpt.torch_convert import extract_member_state_dicts
from councilx_torch.config import Config
from councilx_torch.tools import export_pt
from councilx_torch.train.trainer import CouncilTrainer
from test_torch_train_helpers import batch, raw_config

torch.set_num_threads(2)

STEP = 1
FILES = ("gen", "dis", "dis_council")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(config path, config, snapshot root, the snapshot's payload)."""
    root = tmp_path_factory.mktemp("export")
    raw = raw_config(do_b2a=True)
    cfg_path = str(root / "run.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = CouncilTrainer(Config.from_dict(raw), device="cpu")
    state = trainer.init_state(seed=0)
    state, _ = trainer.train_step(state, *batch())
    ckpts = str(root / "checkpoints")
    save_checkpoint(ckpts, state, STEP)
    return cfg_path, trainer.cfg, ckpts, state.snapshot()


@pytest.mark.parametrize("form", ["root", "step_dir", "state_file"])
def test_export_writes_the_three_reference_files(run, tmp_path, form):
    cfg_path, cfg, ckpts, payload = run
    step_dir = os.path.join(ckpts, f"step_{STEP:08d}")
    checkpoint = {"root": ckpts, "step_dir": step_dir,
                  "state_file": os.path.join(step_dir, "state.pt")}[form]
    files = export_pt.main(["--config", cfg_path, "--checkpoint", checkpoint,
                            "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{name}_{STEP:08d}.pt" for name in FILES)
    assert sorted(files) == sorted(FILES)
    n = cfg.council.council_size
    for name, group in export_pt.FILES:
        got = torch.load(files[name], weights_only=True)
        assert list(got) == [f"{d}_{i}" for d in ("a2b", "b2a")
                             for i in range(n)]
        for d in ("a2b", "b2a"):
            for i, sd in enumerate(payload["params"][d][group]):
                assert all(torch.equal(got[f"{d}_{i}"][k], v)
                           for k, v in sd.items())
                assert list(got[f"{d}_{i}"]) == list(sd)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_export_equals_the_jax_exporters(run, tmp_path):
    """Each member's weights carried into the JAX package's trees and
    exported by its exporters: every tensor equal to the port's file."""
    cfg_path, cfg, ckpts, _ = run
    files = export_pt.main(["--config", cfg_path, "--checkpoint", ckpts,
                            "--out", str(tmp_path)])
    g, d = cfg.gen, cfg.dis
    for name, _ in export_pt.FILES:
        for key, sd in torch.load(files[name], weights_only=True).items():
            if name == "gen":
                want = jexport.export_adain_gen(
                    jconvert.convert_adain_gen(
                        _np(sd), n_downsample=g.n_downsample, n_res=g.n_res,
                        mlp_n_blk=g.mlp_n_blk),
                    n_downsample=g.n_downsample, n_res=g.n_res,
                    mlp_n_blk=g.mlp_n_blk, dim=g.dim)
            else:
                want = jexport.export_ms_image_dis(
                    jconvert.convert_ms_image_dis(_np(sd), d.n_layer,
                                                  d.num_scales),
                    n_layer=d.n_layer, num_scales=d.num_scales)
            assert sorted(want) == sorted(sd), (name, key)
            for k, v in want.items():
                np.testing.assert_array_equal(sd[k].numpy(), v,
                                              err_msg=f"{name} {key} {k}")


def test_export_round_trips_through_the_port_loaders(run, tmp_path):
    cfg_path, cfg, ckpts, payload = run
    files = export_pt.main(["--config", cfg_path, "--checkpoint", ckpts,
                            "--out", str(tmp_path)])
    for d in ("a2b", "b2a"):
        want = payload["params"][d]["gen"]
        got = extract_member_state_dicts(
            torch.load(files["gen"], weights_only=True), d)
        served = load_generator_state_dicts(files["gen"], cfg, d)
        for w, a, b in zip(want, got, served, strict=True):
            assert all(torch.equal(a[k], v) and torch.equal(b[k], v)
                       for k, v in w.items())


def test_export_refuses_a_snapshot_of_another_council(run, tmp_path):
    cfg_path, _, ckpts, _ = run
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw["council"]["council_size"] = 3
    other = str(tmp_path / "other.yaml")
    with open(other, "w") as f:
        yaml.safe_dump(raw, f)
    with pytest.raises(ValueError, match="2 members, the config 3"):
        export_pt.main(["--config", other, "--checkpoint", ckpts,
                        "--out", str(tmp_path / "out")])
