"""The port's train loop and CLI on two processes (gloo), member-sharded.

``councilx_torch.cli.train.main`` with ``--coordinator file://...
--num_processes 2 --process_id r`` on two subprocesses of
tests/torch_dist_worker.py, a council-2 config at 32px with
``num_devices: 2, council_parallel: 2`` (one member per rank), from seeded
JPEG folders:

* the run's files are rank 0's alone (one log record per step, one
  snapshot per cadence step, the summary's size on rank 0 only);
* 2 steps, then ``--resume`` 2 more, end bit for bit where 4 straight steps
  end (parameters, Adam moments and counts, step, z generator);
* a snapshot of the two-process run resumes in one process, and a
  one-process snapshot in two processes, both ending there too (at D = 1
  the member-sharded step is the one-process step, bit for bit);
* both ranks sample the same display batches;
* on the CPU stand-in of the capture context
  (tests/test_torch_capture_helpers.py) the loop compiles the step of every
  trainer type it builds -- one process, the member-sharded and the
  data-parallel trainer on two ranks -- and ends bit for bit where the
  eager loop ends, with its sample sheets and snapshots between the
  compiled steps.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx_torch.ckpt import manager
from councilx_torch.cli import train as train_cli
from torch_dist_worker import launch

TINY = {
    "image_save_iter": 2, "image_display_iter": 1, "display_size": 2,
    "snapshot_save_iter": 2, "log_iter": 1, "max_iter": 1000,
    "batch_size": 2, "compute_dtype": "float32", "num_workers": 1,
    "council": {"council_size": 2, "council_w": 0.2},
    "focus_loss": {"focus_enabled": True},
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
            "n_res": 1},
    "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
    "new_size": 36, "crop_image_height": 32, "crop_image_width": 32,
}


def _folders(root):
    r = np.random.default_rng(1)
    for split in ("trainA", "trainB", "testA", "testB"):
        os.makedirs(root / split)
        for i in range(5):
            Image.fromarray(r.integers(0, 256, (40, 38, 3), dtype=np.uint8)
                            ).save(root / split / f"{i}.jpg")


def _config(path, data_root, **over):
    os.makedirs(path.parent, exist_ok=True)
    path.write_text(yaml.safe_dump({**TINY, "data_root": str(data_root),
                                    **over}))
    return str(path)


def _argv(cfg, out, steps, resume=False):
    return (["--config", cfg, "--output_path", str(out), "--max_steps",
             str(steps)] + (["--resume"] if resume else []))


def _payload(out, step):
    return manager.load_snapshot(os.path.join(
        str(out), "run", "checkpoints", f"step_{step:08d}"))


def _assert_equal(a, b, where="payload"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_equal(u, v, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop2")
    _folders(tmp / "data")
    one = _config(tmp / "one" / "run.yaml", tmp / "data")
    two = _config(tmp / "two" / "run.yaml", tmp / "data", num_devices=2,
                  council_parallel=2)
    # one process: 2 steps (P)
    launch({"scenario": "cli", "argvs": [_argv(one, tmp / "P", 2)]}, 1, tmp)
    shutil.copytree(tmp / "P", tmp / "Q")
    # two processes: 4 straight (S); 2 + 2 resumed (R); P's snapshot + 2 (Q)
    ranks = launch({"scenario": "cli", "argvs": [
        _argv(two, tmp / "S", 4), _argv(two, tmp / "R", 2),
        _argv(two, tmp / "R", 2, resume=True),
        _argv(two, tmp / "Q", 2, resume=True)]}, 2, tmp)
    # one process: R's step-2 snapshot + 2 (T)
    shutil.copytree(tmp / "R", tmp / "T")
    shutil.rmtree(tmp / "T" / "run" / "checkpoints" / "step_00000004")
    launch({"scenario": "cli", "argvs": [_argv(one, tmp / "T", 2,
                                                resume=True)]}, 1, tmp)
    return tmp, ranks


@pytest.fixture(scope="module")
def standin(runs):
    """The loop on the stand-in: one process, 2 steps (C); two ranks,
    member-sharded, 4 steps (SC); two ranks, data-parallel, 2 steps on the
    stand-in (DC) and eagerly (DE). -> the directory, {run: (summary,
    printed)} of rank 0."""
    tmp, _ = runs
    one = str(tmp / "one" / "run.yaml")
    two = str(tmp / "two" / "run.yaml")
    dp = _config(tmp / "dp" / "run.yaml", tmp / "data", num_devices=2)
    first = launch({"scenario": "cli", "standin": [True],
                    "argvs": [_argv(one, tmp / "C", 2)]}, 1, tmp)[0]
    ranks = launch({"scenario": "cli", "standin": [True, True, False],
                    "argvs": [_argv(two, tmp / "SC", 4),
                              _argv(dp, tmp / "DC", 2),
                              _argv(dp, tmp / "DE", 2)]}, 2, tmp)
    out = {"C": (first["summaries"][0], first["printed"][0])}
    for i, name in enumerate(("SC", "DC", "DE")):
        out[name] = (ranks[0]["summaries"][i], ranks[0]["printed"][i])
    return tmp, out


@pytest.mark.parametrize("trainer,name,ref,steps", [
    ("CouncilTrainer", "C", "P", 2), ("CouncilShardTrainer", "SC", "S", 4),
    ("DataParallelTrainer", "DC", "DE", 2)])
def test_train_loop_on_the_stand_in_compiles_every_trainer(
        standin, trainer, name, ref, steps):
    tmp, out = standin
    summary, printed = out[name]
    assert summary["graphs"] is True and len(summary["capture_seconds"]) == 1
    assert f"train step: captured CUDA graphs ({trainer} on cpu)" in printed
    for step in range(2, steps + 1, 2):
        _assert_equal(_payload(tmp / name, step), _payload(tmp / ref, step))
    if ref == "DE":
        assert out[ref][0]["graphs"] is False
        assert f"train step: eager ({trainer} on cpu)" in out[ref][1]


def test_two_process_run_files_are_rank_0s(runs):
    tmp, ranks = runs
    s0, s1 = ranks[0]["summaries"][0], ranks[1]["summaries"][0]
    assert (s0["step"], s1["step"]) == (4, 4)
    assert s0["snapshot_bytes"] > 0 and s1["snapshot_bytes"] is None
    run = tmp / "S" / "run"
    with open(run / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4]
    assert sorted(os.listdir(run / "checkpoints")) == [
        "step_00000002", "step_00000004"]
    assert (run / "index.html").exists() and (run / "config.yaml").exists()
    sheets = sorted(os.listdir(run / "images"))
    assert any("current" in s for s in sheets)


def test_two_process_resume_is_bitwise(runs):
    tmp, ranks = runs
    assert [s["start_step"] for s in ranks[0]["summaries"]] == [0, 0, 2, 2]
    _assert_equal(_payload(tmp / "R", 4), _payload(tmp / "S", 4))
    _assert_equal(_payload(tmp / "R", 2), _payload(tmp / "S", 2))


def test_snapshots_resume_across_layouts(runs):
    tmp, _ = runs
    want = _payload(tmp / "S", 4)
    # one process, 2 steps == two processes, 2 steps
    _assert_equal(_payload(tmp / "P", 2), _payload(tmp / "S", 2))
    # a one-process snapshot resumed by two processes, and the reverse
    _assert_equal(_payload(tmp / "Q", 4), want)
    _assert_equal(_payload(tmp / "T", 4), want)


def test_both_ranks_sample_the_same_display_batches(runs):
    _, ranks = runs
    a, b = ranks[0]["shown"], ranks[1]["shown"]
    assert len(a) == len(b) > 0
    for (ta, ra), (tb, rb) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ra, rb)


def test_train_cli_takes_no_half_given_process_group(tmp_path):
    cfg = _config(tmp_path / "run.yaml", tmp_path)
    with pytest.raises(SystemExit, match="num_processes"):
        train_cli.main(["--config", cfg, "--coordinator", "localhost:1",
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="process id"):
        train_cli.main(["--config", cfg, "--num_processes", "2",
                        "--device", "cpu"])
