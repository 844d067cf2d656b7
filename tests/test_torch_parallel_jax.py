"""The port's multi-process steps against the JAX package's trainers.

Member sharding:

``councilx.parallel.council_shard.CouncilShardTrainer`` on
``make_mesh(2, council_parallel=2)`` (two of the 8 virtual CPU devices
tests/conftest.py pins) and the port's ``CouncilShardTrainer`` on two gloo
ranks (subprocesses of tests/torch_dist_worker.py), council-2 so each shard
holds one member: the tiny parity-mode config of
tests/test_torch_train_helpers.py, the JAX init carried into the port, the
same batch and the global z codes the JAX step draws. Two steps: every
metric within tests/test_torch_train.py's METRIC_RTOL, every parameter
within its bound (2 lr per step: Adam turns rounding-noise gradients into
moves of up to +-lr).

Both axes: the JAX ``CouncilShardTrainer`` on ``make_mesh(4,
council_parallel=2)`` and the port's on four gloo ranks (D = 2 x K = 2, one
member and one row each), with ``det_data_reduction`` off and on, the same
setup and tolerances.

Data parallelism, with the VGG perceptual loss on (``vgg_w: 1``, seeded
random VGG16 weights in a ``.npz``):
``councilx.parallel.mesh.DataParallelTrainer`` on ``make_mesh(2)`` and the
port's ``DataParallelTrainer`` on two gloo ranks (D = 2, one row each), the
same setup and tolerances.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import test_torch_train
from councilx.config import Config as JConfig
from councilx.parallel.council_shard import CouncilShardTrainer as JShard
from councilx.parallel.mesh import DataParallelTrainer as JDataParallel
from councilx.parallel.mesh import make_mesh as jmake_mesh
from councilx_torch.ckpt.manager import train_params_to_state_dicts
from councilx_torch.config import Config
from councilx_torch.nn.vgg import init_random_vgg, save_vgg_npz
from test_torch_train_helpers import (LR, Pair, assert_metrics_close, batch,
                                      max_param_diff, raw_config)
from torch_dist_worker import launch

STEPS = 2


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _jax_steps(jt, jcfg, cfg):
    """STEPS steps of the JAX trainer ``jt`` from its init on the tiny
    batch -> (init as port state dicts, the batch, each step's global z
    codes as tensors, each step's metrics, the final params as port state
    dicts)."""
    js = jt.init_state(jax.random.PRNGKey(0))
    init = train_params_to_state_dicts(jax.device_get(js.params), cfg)
    x_a, x_b = batch()
    # the global z draws of each JAX step, as tests/test_torch_train_helpers
    # derives them from the state's key
    draws = SimpleNamespace(jt=jt, jcfg=jcfg)
    zs, jm = [], []
    for _ in range(STEPS):
        zs.append(_tensors(Pair.jax_zs(draws, js)))
        js, m = jt.train_step(js, x_a, x_b)
        jm.append({k: float(v) for k, v in jax.device_get(m).items()})
    want = train_params_to_state_dicts(jax.device_get(js.params), cfg)
    return init, x_a, x_b, zs, jm, want


def test_member_sharded_step_matches_the_jax_shard_trainer(tmp_path):
    raw = raw_config()
    jcfg, cfg = JConfig.from_dict(raw), Config.from_dict(raw)
    init, x_a, x_b, zs, jm, want = _jax_steps(
        JShard(jcfg, jmake_mesh(2, council_parallel=2)), jcfg, cfg)
    given = str(tmp_path / "given.pt")
    torch.save({"state_dicts": init, "x_a": torch.from_numpy(x_a),
                "x_b": torch.from_numpy(x_b), "zs": zs}, given)
    ranks = launch({"scenario": "steps", "runs": [
        {"name": "K2", "raw": raw, "council": 2, "steps": STEPS,
         "given": given}]}, 2, tmp_path)
    got = ranks[0]["K2"]
    assert [r["K2"]["layout"] for r in ranks] == [(0, 1, 0, 1),
                                                  (0, 1, 1, 1)]
    assert ranks[1]["K2"]["metrics"] == got["metrics"]
    assert_metrics_close(jm, got["metrics"],
                         rtol=test_torch_train.METRIC_RTOL)
    params = SimpleNamespace(state_dicts=lambda: got["snapshot"]["params"])
    assert max_param_diff(want, params) <= 2 * LR * STEPS


@pytest.mark.parametrize("det", [False, True])
def test_data_and_member_sharded_step_matches_the_jax_shard_trainer(
        tmp_path, det):
    raw = raw_config(det_data_reduction=det)
    jcfg, cfg = JConfig.from_dict(raw), Config.from_dict(raw)
    init, x_a, x_b, zs, jm, want = _jax_steps(
        JShard(jcfg, jmake_mesh(4, council_parallel=2)), jcfg, cfg)
    given = str(tmp_path / "given.pt")
    torch.save({"state_dicts": init, "x_a": torch.from_numpy(x_a),
                "x_b": torch.from_numpy(x_b), "zs": zs}, given)
    ranks = launch({"scenario": "steps", "runs": [
        {"name": "D2K2", "raw": raw, "council": 2, "steps": STEPS,
         "given": given}]}, 4, tmp_path)
    got = ranks[0]["D2K2"]
    assert [r["D2K2"]["layout"] for r in ranks] == [
        (0, 2, 0, 1), (0, 2, 1, 1), (1, 2, 0, 1), (1, 2, 1, 1)]
    assert all(r["D2K2"]["metrics"] == got["metrics"] for r in ranks)
    assert_metrics_close(jm, got["metrics"],
                         rtol=test_torch_train.METRIC_RTOL)
    params = SimpleNamespace(state_dicts=lambda: got["snapshot"]["params"])
    assert max_param_diff(want, params) <= 2 * LR * STEPS


def test_data_parallel_vgg_step_matches_the_jax_mesh_trainer(tmp_path):
    vgg_path = str(tmp_path / "vgg16.npz")
    save_vgg_npz(vgg_path, init_random_vgg(torch.Generator().manual_seed(0)))
    raw = raw_config(vgg_w=1.0, vgg_model_path=vgg_path)
    jcfg, cfg = JConfig.from_dict(raw), Config.from_dict(raw)
    init, x_a, x_b, zs, jm, want = _jax_steps(
        JDataParallel(jcfg, jmake_mesh(2)), jcfg, cfg)
    given = str(tmp_path / "given.pt")
    torch.save({"state_dicts": init, "x_a": torch.from_numpy(x_a),
                "x_b": torch.from_numpy(x_b), "zs": zs}, given)
    ranks = launch({"scenario": "steps", "runs": [
        {"name": "D2", "raw": raw, "council": 1, "steps": STEPS,
         "given": given}]}, 2, tmp_path)
    got = ranks[0]["D2"]
    assert [r["D2"]["layout"] for r in ranks] == [(0, 2, 0, 2),
                                                  (1, 2, 0, 2)]
    assert ranks[1]["D2"]["metrics"] == got["metrics"]
    assert all(m["loss_gen_vgg_a2b"] > 0 for m in got["metrics"])
    assert_metrics_close(jm, got["metrics"],
                         rtol=test_torch_train.METRIC_RTOL)
    params = SimpleNamespace(state_dicts=lambda: got["snapshot"]["params"])
    assert max_param_diff(want, params) <= 2 * LR * STEPS
