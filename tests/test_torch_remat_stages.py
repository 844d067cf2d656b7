"""``remat_stages`` in councilx_torch: per-stage recompute of the
generators' content encoder and decoder (``nn/generator.py``).

* bit for bit: the port's train step with ``remat_stages`` (alone, and
  nested in ``remat``) equals the step without it in every parameter,
  Adam moment and metric, on the CPU;
* the recompute: under ``remat_stages`` every conv and norm kernel site of
  a train step runs its forward twice (the forward, then its stage's
  recompute in the backward) and its backward once -- the launch invariant
  ``chip_smoke.py``'s phase 12 checks on the card -- and serving, with
  gradients off, enters no checkpoint;
* two steps against the JAX trainer with ``remat_stages: true``, at
  tests/test_torch_train.py's tolerances.
"""

import pytest
import torch

import chip_smoke
from councilx_torch.config import Config
from councilx_torch.nn import generator
from councilx_torch.ops.conv3x3 import Conv3x3Valid
from councilx_torch.ops.instance_norm import InstanceNorm
from councilx_torch.train.trainer import CouncilTrainer
from test_torch_train_helpers import (LR, Pair, assert_metrics_close, batch,
                                      max_param_diff, raw_config)

torch.set_num_threads(2)


def _steps(steps=2, **over):
    trainer = CouncilTrainer(Config.from_dict(raw_config(**over)),
                             device="cpu")
    state = trainer.init_state(seed=0)
    x_a, x_b = batch()
    metrics = []
    for _ in range(steps):
        state, m = trainer.train_step(state, x_a, x_b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module")
def plain():
    return _steps()


@pytest.mark.parametrize("over", [dict(remat_stages=True),
                                  dict(remat_stages=True, remat=True)],
                         ids=["stages", "stages_in_remat"])
def test_remat_stages_step_is_bit_equal(plain, over):
    want, ws = plain
    got, gs = _steps(**over)
    assert got == want
    a, b = ws.state_dicts(), gs.state_dicts()
    assert all(torch.equal(x[k], y[k]) for d in a for grp in a[d]
               for x, y in zip(a[d][grp], b[d][grp]) for k in x)
    for grp in ("gen", "dis", "cdis"):
        oa, ob = getattr(ws, f"opt_{grp}"), getattr(gs, f"opt_{grp}")
        assert torch.equal(oa.count, ob.count)
        assert all(torch.equal(u, v) for u, v in zip(oa.mu + oa.nu,
                                                    ob.mu + ob.nu))


class _Calls:
    """Counts the kernel sites' autograd Function forwards and backwards
    (the card's launch counters count only CUDA launches)."""

    def __init__(self, monkeypatch):
        self.n = {}
        for cls, name in ((Conv3x3Valid, "conv"), (InstanceNorm, "norm")):
            for phase in ("forward", "backward"):
                self._wrap(monkeypatch, cls, phase, f"{name}_{phase}")

    def _wrap(self, monkeypatch, cls, phase, key):
        fn = getattr(cls, phase)
        self.n[key] = 0

        def counted(ctx, *args):
            self.n[key] += 1
            return fn(ctx, *args)

        monkeypatch.setattr(cls, phase, staticmethod(counted))


def _as_launches(n):
    """The calls as chip_smoke.py's launch counters name them."""
    return {"conv3x3_valid.launches": n["conv_forward"],
            "conv3x3_dgrad.launches": n["conv_backward"],
            "instance_norm.launches": n["norm_forward"],
            "instance_norm_backward.launches": n["norm_backward"]}


def test_remat_stages_recomputes_every_kernel_site_once(monkeypatch):
    calls = _Calls(monkeypatch)
    _steps(steps=1)
    plain = dict(calls.n)
    calls.n.update({k: 0 for k in calls.n})
    _steps(steps=1, remat_stages=True)
    # the tiny config (council-2, n_res 2), per member and step: 8
    # translation resblock convs, 4 in recon_x's decode, 4 in recon_c's
    # encode; 11 translation norms (7 IN, 4 AdaIN), 4 AdaIN in recon_x,
    # 7 IN in recon_c
    sites = {"conv": 2 * (8 + 4 + 4), "norm": 2 * (11 + 4 + 7)}
    for name, n in sites.items():
        assert plain[f"{name}_forward"] == plain[f"{name}_backward"] == n
    assert calls.n == {"conv_forward": 2 * sites["conv"],
                       "conv_backward": sites["conv"],
                       "norm_forward": 2 * sites["norm"],
                       "norm_backward": sites["norm"]}
    assert _as_launches(calls.n) == chip_smoke.remat_stage_launches(
        _as_launches(plain), steps=1)


def test_serving_enters_no_checkpoint(monkeypatch):
    trainer = CouncilTrainer(Config.from_dict(raw_config(remat_stages=True)),
                             device="cpu")
    state = trainer.init_state(seed=0)
    entered = []
    checkpoint = generator.checkpoint

    def spy(*args, **kw):
        entered.append(1)
        return checkpoint(*args, **kw)

    monkeypatch.setattr(generator, "checkpoint", spy)
    x_a, _ = batch()
    with torch.no_grad():
        want = state.gen["a2b"][0](torch.from_numpy(x_a))
    assert not entered
    got = state.gen["a2b"][0](torch.from_numpy(x_a))
    # 7x7, 2 downsamples, the resblocks; resblocks, 2 upsample stages, 7x7
    assert len(entered) == 4 + 4
    assert torch.equal(got.detach(), want)


def test_remat_stages_steps_match_jax():
    jm, pm, want, ps = Pair(remat_stages=True).run(2)
    assert_metrics_close(jm, pm, rtol=1e-5)
    assert max_param_diff(want, ps) <= 2 * LR * 2
