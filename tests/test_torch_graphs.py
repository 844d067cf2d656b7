"""What the captured routes of councilx_torch rest on, on the CPU.

The port's compiled executables (``utils/graphs.py``: the one-process train
step and the serving buckets as CUDA graphs) run only on a card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold each replay
bit-equal to the eager call. Here, against the JAX package where it has a
counterpart:

* ``WeightSchedule.value`` on a 0-d step tensor (the device step a captured
  graph reads) against JAX's jitted ``value`` on a traced step, for every
  anneal kind, warm-up and start gate, over steps 0-119. Tolerance: 1 ulp
  of the schedule's scale max(|base|, |end_value|): XLA on the CPU
  contracts ``base + (end - base) * t`` into one fused multiply-add and
  computes its own cosine, and near ``end_value`` the subtraction cancels,
  so 1 ulp of a term is several of a small result;
* three eager steps whose loss weights are scheduled, with the council and
  focus start gates opening during the run and the council discriminators
  updated every 2nd step (``every_kth``), against the JAX step at the
  tolerances of tests/test_torch_train.py: metrics to 1e-5 relative,
  parameters within 2 * lr per step;
* the in-place Adam update bit-equal to the functional one, every tensor
  keeping its storage, and the train step keeping the state's storage (what
  a replay writes into);
* the eager protocol of ``CouncilTrainer.compile_step`` and
  ``Translator.captured`` (the engine's methods and the GUI's) -- warm-up
  calls, static inputs, the step keys
  of ``every_kth``, the metrics packing, the version bump -- with a CPU
  stand-in for the capture context that re-runs the function on the static
  inputs where a card replays its graph: bit-equal to the eager calls;
* every route that would capture on the CPU raises, the multi-process
  trainers' too, and the defaults keep the CPU engine and loop eager.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from councilx.schedules import WeightSchedule as JWeightSchedule
from councilx_torch.config import Config
from councilx_torch.inference import translate as translate_mod
from councilx_torch.inference.server import BatchingEngine
from councilx_torch.inference.translate import Translator
from councilx_torch.parallel.council_shard import CouncilShardTrainer
from councilx_torch.parallel.mesh import DataParallelTrainer, make_mesh
from councilx_torch.schedules import WeightSchedule
from councilx_torch.train import trainer as trainer_mod
from councilx_torch.train.optim import Adam, assign_
from councilx_torch.train.trainer import GROUPS, CouncilTrainer, group_params
from councilx_torch.utils.graphs import CaptureContext
from test_torch_capture_helpers import _CpuContext, use_stand_in
from test_torch_train_helpers import (LR, Pair, assert_metrics_close, batch,
                                      max_param_diff, raw_config)

torch.set_num_threads(2)

SCHEDULES = {
    "gate": {"base": 0.2, "start_at_iter": 10},
    "warmup": {"base": 0.2, "start_at_iter": 10, "warmup_iters": 25},
    "linear": {"base": 1.0, "anneal": "linear", "anneal_start_iter": 5,
               "anneal_iters": 40, "end_value": 0.1},
    "cosine": {"base": 1.0, "anneal": "cosine", "anneal_start_iter": 0,
               "anneal_iters": 33, "end_value": 0.25, "warmup_iters": 4},
    "step": {"base": 2.0, "anneal": "step", "anneal_start_iter": 7,
             "anneal_step_size": 9, "anneal_gamma": 0.5},
    "cosine_gated": {"base": 0.37, "anneal": "cosine",
                     "anneal_start_iter": 11, "anneal_iters": 29,
                     "end_value": 0.013, "start_at_iter": 3,
                     "warmup_iters": 7},
    "linear_gated": {"base": 5.0, "anneal": "linear", "anneal_start_iter": 2,
                     "anneal_iters": 37, "end_value": 0.3,
                     "start_at_iter": 1, "warmup_iters": 13},
    "step_warmup": {"base": 0.7, "anneal": "step", "anneal_start_iter": 3,
                    "anneal_step_size": 7, "anneal_gamma": 0.9,
                    "start_at_iter": 2, "warmup_iters": 3},
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_device_step_schedule_matches_jitted_jax(kind):
    sched = SCHEDULES[kind]
    ts = WeightSchedule.from_value(sched)
    value = jax.jit(JWeightSchedule.from_value(sched).value)
    scale = max(abs(ts.base), abs(ts.end_value))
    ulp = float(np.spacing(np.float32(scale)))
    for step in range(120):
        got = ts.value(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = np.float32(value(jnp.int32(step)))
        assert abs(float(got) - float(want)) <= ulp, (step, float(got),
                                                      float(want))


def test_constant_weight_stays_a_python_float():
    assert WeightSchedule.from_value(0.3).value(torch.tensor(5)) == 0.3


# the start gates open during the run (council at step 1, focus at 2), the
# weights move every step, the council discriminators update at 0 and 2
SCHEDULED = dict(
    recon_x_w={"base": 10.0, "anneal": "linear", "anneal_start_iter": 0,
               "anneal_iters": 3, "end_value": 2.0},
    council={"council_w": {"base": 0.2, "start_at_iter": 1,
                           "warmup_iters": 2},
             "council_start_at_iter": 1, "focus_start_at_iter": 2,
             "mask_total_w": {"base": 0.005, "anneal": "cosine",
                              "anneal_start_iter": 1, "anneal_iters": 2,
                              "end_value": 0.001},
             "council_dis_relative_iteration": 2,
             "cdis_ratio_mode": "every_kth"})


def test_scheduled_steps_with_gates_opening_match_jax():
    pair = Pair(**SCHEDULED)
    assert pair.cfg.loss_schedules.keys() == {"recon_x_w", "council_w",
                                              "mask_total_w"}
    jm, pm, want, ps = pair.run(3)
    assert_metrics_close(jm, pm, rtol=1e-5)
    assert max_param_diff(want, ps) <= 2 * LR * 3
    assert [m["cdis_updated"] for m in pm] == [1.0, 0.0, 1.0]


def _adam_case(mu_dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) for s in shapes]
             for _ in range(3)]
    return Adam(1e-3, 0.5, 0.999, 1e-4, 2, 0.5, mu_dtype), params, grads


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16])
def test_in_place_adam_is_the_functional_update(mu_dtype):
    tx, params, grads = _adam_case(mu_dtype)
    ref_params = [p.clone() for p in params]
    ref = tx.init(ref_params)
    state = tx.init(params)
    ptrs = [t.data_ptr() for t in params + state.mu + state.nu
            + [state.count]]
    for gs in grads:
        ref_params, ref = tx.update(ref_params, gs, ref)
        assign_(params, state, *tx.update(params, gs, state))
        assert [t.data_ptr() for t in params + state.mu + state.nu
                + [state.count]] == ptrs
        for a, b in zip(params + state.mu + state.nu,
                        [*ref_params, *ref.mu, *ref.nu]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(state.count, ref.count)


def test_adam_update_relays_permuted_gradients_exactly():
    """A gradient laid out other than its parameter (autograd's permuted
    ones) is copied to the parameter's layout before the foreach ops: the
    update is bit-equal to the one on the contiguous gradient."""
    tx, params, grads = _adam_case(None)
    perm = [g.t() if g.dim() == 2 else g for g in
            [torch.randn(4, 3, generator=torch.Generator().manual_seed(1)),
             *grads[0][1:]]]
    flat = [g.contiguous() for g in perm]
    assert perm[0].stride() != params[0].stride()
    a, sa = tx.update(params, perm, tx.init(params))
    b, sb = tx.update(params, flat, tx.init(params))
    for x, y in zip([*a, *sa.mu, *sa.nu], [*b, *sb.mu, *sb.nu]):
        assert x.stride() == y.stride() and torch.equal(x, y)


def _storage(state):
    return [t.data_ptr() for grp in GROUPS
            for t in group_params(getattr(state, grp))
            + getattr(state, f"opt_{grp}").mu
            + getattr(state, f"opt_{grp}").nu
            + [getattr(state, f"opt_{grp}").count]]


@pytest.mark.parametrize("guard", [False, True])
def test_train_step_writes_the_state_in_place(guard):
    trainer = CouncilTrainer(Config.from_dict(raw_config(
        skip_nonfinite_updates=guard)), device="cpu")
    state = trainer.init_state(seed=1)
    opts = [state.opt_gen, state.opt_dis, state.opt_cdis]
    before = _storage(state)
    x_a, x_b = batch(2)
    for _ in range(2):
        state, _ = trainer.train_step(state, x_a, x_b)
    assert _storage(state) == before
    assert [state.opt_gen, state.opt_dis, state.opt_cdis] == opts
    assert int(state.opt_gen.count) == 2


# --- the capture protocol, with a CPU stand-in for the capture context ----


def _compiled_vs_eager(steps, **over):
    cfg = Config.from_dict(raw_config(**over))
    eager = CouncilTrainer(cfg, device="cpu")
    ref = eager.init_state(seed=4)
    comp = CouncilTrainer(cfg, device="cpu")
    state = comp.load_state(ref.state_dicts(), seed=4)
    ref = eager.load_state(ref.state_dicts(), seed=4)
    step = trainer_mod.CompiledStep(comp, state)
    x_a, x_b = batch(3)
    for i in range(steps):
        zs = eager.draw_zs(ref, x_a.shape[0])
        ref, want = eager.train_step(ref, x_a, x_b, zs=zs)
        state, got = step(state, x_a, x_b, zs=zs)
        assert list(got) == list(want), i
        for k in want:
            assert torch.equal(got[k], want[k].float()), (i, k)
    for d in comp.directions:
        for grp in GROUPS:
            for a, b in zip(getattr(state, grp)[d], getattr(ref, grp)[d]):
                for (n, p), q in zip(a.named_parameters(), b.parameters()):
                    assert torch.equal(p, q), (d, grp, n)
    assert state.step == ref.step == steps
    return step


@pytest.mark.parametrize("case,over,keys", [
    ("plain", {}, 1),
    ("every_kth", dict(council={"council_dis_relative_iteration": 2,
                                "cdis_ratio_mode": "every_kth"}), 2),
    ("k_per_step", dict(council={"council_dis_relative_iteration": 2,
                                 "cdis_ratio_mode": "k_per_step"}), 1),
    ("per_phase", dict(z_mode="per_phase", skip_nonfinite_updates=True), 1),
    ("scheduled", SCHEDULED, 2),
])
def test_compiled_step_protocol_is_the_eager_step(monkeypatch, case, over,
                                                  keys):
    monkeypatch.setattr(trainer_mod, "CaptureContext", _CpuContext)
    step = _compiled_vs_eager(4, **over)
    # one warm-up (eager) call per step shape, then one capture each
    assert len(step.calls) == keys and step.ctx.runs == keys
    assert step.warmed == set(step.calls)
    assert sum(c.replays for c, _ in step.calls.values()) == 4 - keys


def test_compiled_step_refuses_another_state(monkeypatch):
    monkeypatch.setattr(trainer_mod, "CaptureContext", _CpuContext)
    trainer = CouncilTrainer(Config.from_dict(raw_config()), device="cpu")
    step = trainer_mod.CompiledStep(trainer, trainer.init_state(0))
    x_a, x_b = batch(0)
    with pytest.raises(ValueError, match="another TrainState"):
        step(trainer.init_state(0), x_a, x_b)


def test_compiled_step_bumps_the_parameters_versions(monkeypatch):
    """A replay writes the parameters without autograd seeing it, so the
    compiled step bumps their versions: a no-grad derived-weight cache
    must not serve the weights of before the step."""
    monkeypatch.setattr(trainer_mod, "CaptureContext", _CpuContext)
    trainer = CouncilTrainer(Config.from_dict(raw_config()), device="cpu")
    state = trainer.init_state(0)
    step = trainer_mod.CompiledStep(trainer, state)
    p = next(state.gen["a2b"][0].parameters())
    x_a, x_b = batch(0)
    for i in range(3):
        v = p._version
        step(state, x_a, x_b)
        assert p._version > v, i


@pytest.mark.parametrize("all_members", [False, True])
@pytest.mark.parametrize("wire", ["u8", "f32"])
def test_engine_capture_protocol_is_the_eager_engine(monkeypatch,
                                                     all_members, wire):
    monkeypatch.setattr(translate_mod, "CaptureContext", _CpuContext)
    cfg = Config.from_dict(raw_config())
    tr = Translator(cfg, device="cpu")
    gens = tr.init_members(2, seed=5)
    params = gens if all_members else gens[1]
    r = np.random.default_rng(0)
    if wire == "u8":
        imgs = r.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    else:
        imgs = r.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    outs = {}
    for graphs in (False, True):
        eng = BatchingEngine(tr, params, (32, 32), max_batch=4,
                             max_delay_ms=50.0, wire_format=wire,
                             all_members=all_members)
        assert eng.graphs is False
        # the captured route, over the CPU stand-in of the capture
        eng.graphs = graphs
        eng.start()
        try:
            eng.warmup()
            outs[graphs] = [f.result(timeout=120) for f in
                            [eng.submit(x, seed=i)
                             for i, x in enumerate(imgs)]]
        finally:
            eng.stop()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    # one capture per bucket of the ladder, kept until new members load
    assert len(tr._captured) == len(eng.buckets) == 3
    tr.load_members([g.state_dict() for g in gens])
    assert not tr._captured


@pytest.mark.parametrize("method", ["translate", "translate_all_members"])
def test_translator_captures_the_gui_methods(monkeypatch, method):
    """The GUI's per-request calls, one image: float images and masks;
    translate_all_members takes a z per member."""
    monkeypatch.setattr(translate_mod, "CaptureContext", _CpuContext)
    tr = Translator(Config.from_dict(raw_config()), device="cpu")
    gens = tr.init_members(2, seed=6)
    params = gens if method == "translate_all_members" else gens[1]
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    z = torch.from_numpy(r.standard_normal(
        (2, 1, 3) if method == "translate_all_members" else (1, 3)).astype(
        np.float32))
    got = tr.captured(method, params, 1, (32, 32))(x, z)
    want = getattr(tr, method)(params, x, z)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_captured_rejects_a_method_it_does_not_capture():
    tr = Translator(Config.from_dict(raw_config()), device="cpu")
    with pytest.raises(ValueError, match="is not one of"):
        tr.captured("encode_style", None, 1, (32, 32))


# --- no capture on the CPU, and the CPU defaults stay eager ----------------


def test_capture_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA graphs capture CUDA work"):
        CaptureContext("cpu")
    trainer = CouncilTrainer(Config.from_dict(raw_config()), device="cpu")
    with pytest.raises(ValueError, match="compile_step"):
        trainer.compile_step(trainer.init_state(0))
    tr = Translator(Config.from_dict(raw_config()), device="cpu")
    gen = tr.init_members(1, seed=0)[0]
    with pytest.raises(ValueError, match="CUDA graphs capture CUDA work"):
        tr.captured("translate_u8io_device", gen, 1, (32, 32))
    assert BatchingEngine(tr, gen, (32, 32)).graphs is False


@pytest.mark.parametrize("trainer_type", [DataParallelTrainer,
                                          CouncilShardTrainer])
def test_multi_process_trainers_compile_on_a_card_only(tmp_path,
                                                       trainer_type):
    """compile_step takes every trainer type (tests/test_torch_parallel_*
    drive the multi-process ones over the CPU stand-in), and on a CPU
    device it raises for them too: here in a gloo world of one rank."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, always_2d=trainer_type is CouncilShardTrainer)
        trainer = trainer_type(Config.from_dict(raw_config()), mesh,
                               device="cpu")
        assert "D=1 x K=1 grid, rank 0 of 1 (gloo)" in trainer.layout()
        with pytest.raises(ValueError, match="compile_step"):
            trainer.compile_step(trainer.init_state(0))
    finally:
        dist.destroy_process_group()


def test_train_loop_on_the_cpu_steps_eagerly(tmp_path, capsys):
    from councilx_torch.train import loop

    cfg = Config.from_dict(raw_config(log_iter=1, image_save_iter=0,
                                      image_display_iter=0,
                                      snapshot_save_iter=0))
    out = loop.train(cfg, output_path=str(tmp_path), run_name="eager",
                     synthetic=True, max_steps=1, device="cpu")
    assert out["graphs"] is False and out["capture_seconds"] == []
    assert "train step: eager (CouncilTrainer on cpu)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("fail", [False, True])
def test_train_loop_drops_the_compiled_step_when_it_ends(monkeypatch,
                                                         tmp_path, fail):
    """A compiled step's graphs hold the NCCL communicators of its
    collectives, and destroying a process group waits until every such
    graph is freed: the loop (on the stand-in) drops its compiled step
    before it returns, and before an error leaves it, whose traceback
    keeps the loop's frame."""
    import gc
    import weakref

    from councilx_torch.train import loop

    use_stand_in(monkeypatch.setattr)
    made = []
    compile_step = CouncilTrainer.compile_step

    def recorded(self, state):
        step = compile_step(self, state)
        made.append(weakref.ref(step))
        return step

    monkeypatch.setattr(CouncilTrainer, "compile_step", recorded)
    if fail:
        host_metrics, logged = loop._host_metrics, []

        def failing(metrics):
            logged.append(1)
            if len(logged) == 2:
                raise RuntimeError("a failed log")
            return host_metrics(metrics)

        monkeypatch.setattr(loop, "_host_metrics", failing)
    cfg = Config.from_dict(raw_config(log_iter=1, image_save_iter=0,
                                      image_display_iter=0,
                                      snapshot_save_iter=0))
    try:
        out = loop.train(cfg, output_path=str(tmp_path), run_name="c",
                         synthetic=True, max_steps=3, device="cpu")
    except RuntimeError as e:
        assert fail and "a failed log" in str(e)
        # while the traceback (and with it the loop's frame) is alive; the
        # stand-in keeps the captured function, a cycle through the step
        # (a card's graph keeps none), so collect it
        gc.collect()
        assert len(made) == 1 and made[0]() is None
    else:
        assert not fail and out["graphs"] is True
        assert len(out["capture_seconds"]) == 1
        gc.collect()
        assert len(made) == 1 and made[0]() is None
