"""The port's train loop, snapshots, logging and sample sheets, on the CPU.

A council-2 config at 32px (gen dim 8) trains from seeded JPEG folders
through ``councilx_torch.train.loop.train`` and its CLI:

* 4 steps in one run and 2 steps + ``--resume`` 2 steps end bitwise equal:
  every parameter, every Adam moment and count, the step and the z
  generator's state;
* an async snapshot round-trips and the newest three are kept;
* SIGTERM after the first step leaves a final, resumable snapshot and exit
  code 0;
* what the loop does not take is refused.

The sample-sheet helpers are held against the JAX package's.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx.utils import images as jimages
from councilx_torch.ckpt import manager
from councilx_torch.cli import train as train_cli
from councilx_torch.config import Config
from councilx_torch.train import loop
from councilx_torch.train.trainer import CouncilTrainer
from councilx_torch.utils import images
from councilx_torch.utils.logging import MetricLogger, prepare_sub_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "image_save_iter": 2, "image_display_iter": 1, "display_size": 2,
    "snapshot_save_iter": 2, "log_iter": 1, "max_iter": 1000,
    "batch_size": 2, "compute_dtype": "float32", "num_workers": 2,
    "council": {"council_size": 2, "council_w": 0.2},
    "focus_loss": {"focus_enabled": True},
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
            "n_res": 1},
    "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
    "new_size": 36, "crop_image_height": 32, "crop_image_width": 32,
}


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


def _config_file(tmp_path, data_root, name="tiny", **over):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({**TINY, "data_root": str(data_root),
                                    **over}))
    return str(path)


def _assert_payloads_equal(a, b, where="payload"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_payloads_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_payloads_equal(u, v, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _final(out, name="tiny"):
    root = os.path.join(out, name, "checkpoints")
    step, path = manager.latest_checkpoint(root)
    return step, manager.load_snapshot(path)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, data_root):
    cfg_path = _config_file(tmp_path, data_root)
    one = str(tmp_path / "one")
    two = str(tmp_path / "two")
    s4 = train_cli.main(["--config", cfg_path, "--output_path", one,
                         "--max_steps", "4", "--device", "cpu"])
    s2 = train_cli.main(["--config", cfg_path, "--output_path", two,
                         "--max_steps", "2", "--device", "cpu"])
    s22 = train_cli.main(["--config", cfg_path, "--output_path", two,
                          "--max_steps", "2", "--resume", "--device", "cpu"])
    assert (s4["step"], s2["step"]) == (4, 2)
    assert (s22["start_step"], s22["step"]) == (2, 4)
    step_a, a = _final(one)
    step_b, b = _final(two)
    assert step_a == step_b == a["step"] == 4
    assert [int(a["opt"][g]["count"]) for g in ("gen", "dis", "cdis")] == \
        [4, 4, 4]
    _assert_payloads_equal(a, b)
    # the logs agree too, step for step
    def logged(out):
        with open(os.path.join(out, "tiny", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return {r["step"]: {k: v for k, v in r.items()
                            if k not in ("time", "images_per_sec")}
                for r in recs}
    assert logged(one) == logged(two)
    assert sorted(logged(one)) == [1, 2, 3, 4]
    run = os.path.join(one, "tiny")
    for name in ("config.yaml", "index.html", "images/current.jpg",
                 "images/test_00000002.jpg", "images/train_00000004.jpg"):
        assert os.path.exists(os.path.join(run, name)), name
    assert [s for s, _ in manager.list_checkpoints(
        os.path.join(run, "checkpoints"))] == [2, 4]


def test_host_prefetch_changes_nothing(tmp_path, data_root):
    """Staging step k+1 in the worker thread or in line gives the same
    run."""
    outs = []
    for prefetch in (True, False):
        out = str(tmp_path / f"p{int(prefetch)}")
        cfg = Config.from_dict({**TINY, "data_root": str(data_root),
                                "host_prefetch": prefetch,
                                "image_save_iter": 0,
                                "image_display_iter": 0})
        loop.train(cfg, output_path=out, run_name="tiny", max_steps=2,
                   device="cpu")
        outs.append(_final(out)[1])
    _assert_payloads_equal(*outs)


def test_async_snapshot_round_trips_and_keeps_three(tmp_path):
    cfg = Config.from_dict(TINY)
    trainer = CouncilTrainer(cfg, device="cpu")
    state = trainer.init_state(seed=3)
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    state, _ = trainer.train_step(state, x, x)
    root = str(tmp_path / "ck")
    want = state.snapshot()
    path = manager.save_checkpoint(root, state, 1, async_save=True)
    # the step updates the parameters in place at once: the snapshot's
    # host copy was taken before save_checkpoint returned
    state, _ = trainer.train_step(state, x, x)
    manager.wait_for_checkpoints()
    assert path == os.path.join(os.path.abspath(root), "step_00000001")
    payload, step = manager.restore_checkpoint(root)
    assert step == 1
    _assert_payloads_equal(payload, want)
    # restore_state rebuilds the state; its next step matches a step from
    # the original state at that point
    restored = trainer.restore_state(payload)
    assert restored.step == 1
    _assert_payloads_equal(restored.snapshot(), want)
    for s in range(2, 6):
        manager.save_checkpoint(root, restored, s, async_save=True)
    manager.wait_for_checkpoints()
    assert [s for s, _ in manager.list_checkpoints(root)] == [3, 4, 5]
    assert not [n for n in os.listdir(root) if n.startswith(".")]
    # serving reads the newest snapshot's generators
    gens = manager.load_generator_state_dicts(root, cfg)
    assert len(gens) == 2
    for sd, want_sd in zip(gens, restored.state_dicts()["a2b"]["gen"]):
        assert sd.keys() == want_sd.keys()
        assert all(torch.equal(sd[k], want_sd[k]) for k in sd)


def test_snapshot_write_errors_surface_on_wait(tmp_path, monkeypatch):
    cfg = Config.from_dict(TINY)
    state = CouncilTrainer(cfg, device="cpu").init_state(seed=0)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(manager.torch, "save", fail)
    manager.save_checkpoint(str(tmp_path), state, 1, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        manager.wait_for_checkpoints()
    manager.wait_for_checkpoints()      # reported once


def test_sigterm_leaves_a_final_resumable_snapshot(tmp_path, data_root):
    cfg_path = _config_file(tmp_path, data_root, image_save_iter=0,
                            image_display_iter=0, snapshot_save_iter=0)
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "councilx_torch.cli.train", "--config",
         cfg_path, "--output_path", out, "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    log = os.path.join(out, "tiny", "metrics.jsonl")
    try:
        deadline = time.time() + 240
        while not (os.path.exists(log) and os.path.getsize(log)):
            assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline, "no step logged in time"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stdout
    assert "'interrupted': True" in stdout, stdout
    step, payload = _final(out)
    assert step >= 1 and payload["step"] == step
    summary = train_cli.main(["--config", cfg_path, "--output_path", out,
                              "--resume", "--max_steps", "1",
                              "--device", "cpu"])
    assert (summary["start_step"], summary["step"]) == (step, step + 1)


@pytest.mark.parametrize("over,what", [
    ({"num_devices": 2}, "num_devices"),
    ({"num_devices": 2, "council_parallel": 2}, "council_parallel"),
    ({"num_devices": 2, "det_data_reduction": True}, "det_data_reduction"),
    ({"vgg_w": 1.0}, "vgg_w")])
def test_loop_refuses_what_is_not_ported(tmp_path, over, what):
    """vgg_w is not ported; the multi-GPU layouts are, one process per GPU,
    so one process asked for one refuses and names torchrun."""
    cfg = Config.from_dict({**TINY, **over})
    err, why = ((NotImplementedError, "not ported yet") if "vgg_w" in over
                else (ValueError, "torchrun"))
    with pytest.raises(err, match=what):
        loop.make_trainer(cfg, device="cpu")
    with pytest.raises(err, match=why):
        loop.train(cfg, output_path=str(tmp_path), synthetic=True,
                   device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_train_cli_refuses_multi_host(tmp_path):
    """A coordinator without the process count is refused, not trained
    alone (the multi-process launch: test_torch_parallel_loop.py)."""
    cfg_path = _config_file(tmp_path, "unused")
    with pytest.raises(SystemExit, match="--num_processes"):
        train_cli.main(["--config", cfg_path, "--coordinator",
                        "localhost:1234", "--device", "cpu"])


def test_mask_skipped_metrics():
    m = loop.mask_skipped_metrics({"cdis_updated": 0.0,
                                   "loss_dis_council": 0.0,
                                   "finite_cdis": 1.0, "loss_dis_adv": 2.0})
    assert m == {"loss_dis_adv": 2.0}
    m = loop.mask_skipped_metrics({"cdis_updated": 1.0,
                                   "loss_dis_council": 3.0})
    assert m == {"loss_dis_council": 3.0}


def test_logger_writes_jsonl(tmp_path):
    ck, im = prepare_sub_folder(str(tmp_path / "run"))
    assert os.path.isdir(ck) and os.path.isdir(im)
    logger = MetricLogger(str(tmp_path / "run"), use_tensorboard=False)
    logger.write(3, {"a": torch.tensor(1.5), "b": 2})
    logger.close()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rec = json.loads(f.read())
    assert rec["step"] == 3 and rec["a"] == 1.5 and rec["b"] == 2.0


# ---------------------------------------------------------------------------
# sample sheets, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,nrow", [(1, 8), (6, 3), (7, 3), (16, 8)])
def test_make_grid_matches_jax(k, nrow):
    x = np.random.default_rng(k).integers(0, 256, (k, 9, 7, 3),
                                          dtype=np.uint8)
    np.testing.assert_array_equal(images.make_grid(x, nrow=nrow),
                                  jimages.make_grid(x, nrow=nrow))


@pytest.mark.parametrize("with_masks", [False, True])
def test_write_sample_sheet_matches_jax(tmp_path, with_masks):
    r = np.random.default_rng(5)
    x = r.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    outs = r.uniform(-1.2, 1.2, (2, 3, 16, 16, 3)).astype(np.float32)
    masks = (r.uniform(0, 1, (2, 3, 16, 16, 1)).astype(np.float32)
             if with_masks else None)
    want = jimages.write_sample_sheet(str(tmp_path), "jax", x, outs, masks)
    got = images.write_sample_sheet(str(tmp_path), "port", x, outs, masks)
    assert os.path.basename(got) == "port.jpg"
    np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                  np.asarray(Image.open(want)))
    rows = 1 + 2 * (2 if with_masks else 1)
    assert np.asarray(Image.open(got)).shape == (rows * 18 + 2, 3 * 18 + 2,
                                                 3)


def test_write_html_matches_jax(tmp_path):
    for step in (2, 4):
        for tag in ("train", "test"):
            (tmp_path / f"{tag}_{step:08d}.jpg").write_bytes(b"")
    images.write_html(str(tmp_path / "port.html"), str(tmp_path), 4, 2)
    jimages.write_html(str(tmp_path / "jax.html"), str(tmp_path), 4, 2)
    assert (tmp_path / "port.html").read_text() == \
        (tmp_path / "jax.html").read_text()
