"""The port's recorder (``councilx_torch/utils/trace.py``) and what records
into it, on the CPU: the bound and the off switch, each request's five
stages in ``BatchingEngine`` and the engine's always-on stage means, the
compiled step's spans (over the CPU stand-in of the capture), and the
kernel loads. The device marks and the clock anchors need a card
(``tests/test_torch_cuda.py``)."""

import ctypes
import threading

import numpy as np
import pytest
import torch

from councilx_torch.config import Config
from councilx_torch.inference.server import STAGES, BatchingEngine
from councilx_torch.inference.translate import Translator
from councilx_torch.ops import _build
from councilx_torch.train import trainer as trainer_mod
from councilx_torch.train.trainer import CouncilTrainer
from councilx_torch.utils import trace
from test_torch_capture_helpers import _CpuContext
from test_torch_train_helpers import batch, raw_config

torch.set_num_threads(2)

HW = 32


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.off()
    trace.clear()
    yield
    trace.off()
    trace.clear()


@pytest.fixture(scope="module")
def translator():
    tr = Translator(Config.from_dict(raw_config()), device="cpu")
    return tr, tr.init_members(2, seed=5)


def test_off_records_nothing():
    with trace.span("a"):
        trace.count("c")
        trace.add("b", 0, 1)
    assert trace.span("a") is trace.span("b")       # one shared no-op
    assert trace.device_mark("m", "cpu") is None
    assert (trace.records(), trace.counts(), trace.marks(),
            trace.dropped()) == ([], {}, [], 0)


def test_on_records_nested_spans_and_counts():
    trace.on()
    with trace.span("outer", 7):
        with trace.span("inner", 7):
            trace.count("c", 2)
        trace.count("c")
    trace.add("x", 5, 9, 3, ("extra",))
    trace.off()
    with trace.span("after"):
        pass
    inner, outer, x = trace.records()
    me = threading.get_ident()
    assert (inner[0], outer[0], inner[1], outer[4]) == ("inner", "outer",
                                                        me, 7)
    assert outer[2] <= inner[2] <= inner[3] <= outer[3]
    assert x == ("x", me, 5, 9, 3, ("extra",))
    assert trace.counts() == {"c": 3}
    assert trace.thread_names() == {me: threading.current_thread().name}


def test_the_bound_counts_drops():
    trace.on(limit=3)
    for i in range(5):
        trace.add("r", i, i + 1)
    with trace.span("late"):
        pass
    assert [r[2] for r in trace.records()] == [0, 1, 2]
    assert trace.dropped() == 3
    trace.clear()
    assert (trace.records(), trace.dropped()) == ([], 0)


def _serve(translator, record: bool, pipeline: bool = True):
    tr, gens = translator
    if record:
        trace.on()
    engine = BatchingEngine(tr, gens[0], (HW, HW), max_batch=4,
                            max_delay_ms=200.0, pipeline=pipeline)
    r = np.random.default_rng(0)
    imgs = r.integers(0, 256, (6, HW, HW, 3), dtype=np.uint8)
    engine.start()
    try:
        outs = [f.result(timeout=120) for f in
                [engine.submit(x, seed=i) for i, x in enumerate(imgs)]]
        stats = engine.snapshot_stats()
    finally:
        engine.stop()
    trace.off()
    return outs, stats


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_stages_are_contiguous_and_sum_to_the_engine_time(
        translator, pipeline):
    outs, stats = _serve(translator, True, pipeline)
    recs = trace.records()
    reqs = [r for r in recs if r[0] == "engine.request"]
    assert len(reqs) == 6
    for name, _, t0, t1, bid, stamps in reqs:
        edges = (t0, *stamps, t1)
        stages = np.diff(edges)
        assert len(stages) == len(STAGES) and (stages >= 0).all()
        assert stages.sum() == t1 - t0
    # 6 requests within the deadline: a batch of 4 and one of 2
    assert sorted(np.bincount([r[4] for r in reqs]).tolist()) == [2, 4]
    assert stats["batch_size_histogram"] == {2: 1, 4: 1}
    names = trace.thread_names()
    by_thread = {}
    for r in recs:
        if r[0] != "engine.request":
            by_thread.setdefault(names[r[1]], set()).add(r[0])
    dispatch = {"engine.collect", "engine.assemble", "engine.eager"}
    readback = {"engine.d2h", "engine.resolve"}
    if pipeline:
        assert by_thread["councilx-serve-d"] == dispatch | {"engine.handoff"}
        assert by_thread["councilx-serve-r"] == readback
        assert {names[r[1]] for r in reqs} == {"councilx-serve-r"}
    else:
        assert by_thread["councilx-serve-d"] == dispatch | readback


def test_engine_stage_means_sum_to_the_mean_latency(translator):
    _, stats = _serve(translator, False)
    means = stats["mean_stage_ms"]
    assert list(means) == list(STAGES) and min(means.values()) >= 0
    assert stats["mean_latency_ms"] > 0
    assert abs(sum(means.values()) - stats["mean_latency_ms"]) <= 0.005


def test_engine_off_records_nothing_and_serves_the_same(translator):
    off, stats_off = _serve(translator, False)
    assert trace.records() == []
    on, stats_on = _serve(translator, True)
    assert trace.records()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert stats_off["batch_size_histogram"] == \
        stats_on["batch_size_histogram"]


def test_compiled_step_spans_and_the_same_step(monkeypatch):
    monkeypatch.setattr(trainer_mod, "CaptureContext", _CpuContext)
    cfg = Config.from_dict(raw_config())
    x_a, x_b = batch(3)
    got = {}
    for record in (False, True):
        trainer = CouncilTrainer(cfg, device="cpu")
        state = trainer.init_state(seed=4)
        step = trainer_mod.CompiledStep(trainer, state)
        if record:
            trace.on()
        # warm-up (eager), capture and replay, replay
        got[record] = [step(state, x_a, x_b, zs=trainer.draw_zs(state, 2))[1]
                       for _ in range(3)]
        trace.off()
        if not record:
            assert trace.records() == []
    for want, have in zip(got[False], got[True]):
        assert list(want) == list(have)
        for k in want:
            assert torch.equal(want[k], have[k]), k
    names = [r[0] for r in trace.records()]
    assert names.count("step.prepare") == 3
    assert names.count("step.replay") == names.count("step.finish") == 2
    # the CPU records no device marks, so no phase reads
    assert step.marks and all(v == [] for v in step.marks.values())
    assert step.phase_ms() == {}


def test_kernel_loads_are_spanned_and_counted(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "_compile", lambda names: len(names) - 1)
    monkeypatch.setattr(_build, "_library_path",
                        lambda name: str(tmp_path / name))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("lib", path))
    trace.on()
    _build.build_cuda_libraries(["k1", "k2"])
    assert _build.load_cuda_library("k1") == ("lib", str(tmp_path / "k1"))
    _build.load_cuda_library("k3")                   # a miss loads it
    _build.build_cuda_libraries(["k1", "k3"])        # nothing to do
    assert [r[0] for r in trace.records()] == ["setup.kernel_load"] * 2
    assert trace.counts() == {"kernels_built": 1, "kernels_loaded": 3}
