"""councilx_torch's config and schedules vs the JAX package's."""

import glob
import os

import numpy as np
import pytest

from councilx.config import Config as JConfig
from councilx.config import load_config as jload_config
from councilx.schedules import WeightSchedule as JWeightSchedule
from councilx_torch.config import Config, load_config
from councilx_torch.schedules import WeightSchedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_loads_the_same(path):
    assert load_config(path).to_dict() == jload_config(path).to_dict()


def test_defaults_and_schedule_dicts_round_trip_the_same():
    raw = {"council": {"council_w": {"base": 0.2, "start_at_iter": 10,
                                     "warmup_iters": 5}},
           "recon_x_w": {"base": 10.0, "anneal": "cosine",
                         "anneal_start_iter": 3, "anneal_iters": 7,
                         "end_value": 1.0},
           "unknown_key": [1, 2]}
    assert Config.from_dict(raw).to_dict() == JConfig.from_dict(raw).to_dict()
    assert Config().to_dict() == JConfig().to_dict()
    d = Config.from_dict(raw).to_dict()
    assert Config.from_dict(d).to_dict() == d


@pytest.mark.parametrize("sched", [
    {"base": 0.3},
    {"base": 0.2, "start_at_iter": 10},
    {"base": 0.2, "start_at_iter": 10, "warmup_iters": 25},
    {"base": 1.0, "anneal": "linear", "anneal_start_iter": 5,
     "anneal_iters": 40, "end_value": 0.1},
    {"base": 1.0, "anneal": "cosine", "anneal_start_iter": 0,
     "anneal_iters": 33, "end_value": 0.25, "warmup_iters": 4},
    {"base": 2.0, "anneal": "step", "anneal_start_iter": 7,
     "anneal_step_size": 9, "anneal_gamma": 0.5},
])
def test_weight_schedule_value_agrees(sched):
    ts, js = WeightSchedule.from_value(sched), JWeightSchedule.from_value(sched)
    assert ts.to_value() == js.to_value()
    for step in (0, 1, 4, 5, 9, 10, 11, 17, 22, 34, 35, 44, 60, 1000):
        got = ts.value(step)
        assert isinstance(got, float)
        # JAX evaluates in float32, the port in float64
        np.testing.assert_allclose(got, float(js.value(step)), rtol=1e-6,
                                   atol=1e-7)
