"""councilx_torch's multi-process trainers on the CPU over gloo, against the
one-process CouncilTrainer step.

Every rank is a subprocess of tests/torch_dist_worker.py (one thread, a
``file://`` rendezvous). A council-4 config at 32px (gen and dis dim 8),
global batch 4, f32 parity mode, focus mask and the skip-nonfinite gate on;
every layout starts from ``init_state(0)`` and draws the global z stream
from the same generator, so it is the one-process step's init, batch and z:

* member parallelism (D = 1, K in {2, 4}): two steps leave every member's
  parameters, buffers and Adam moments (the snapshot gathered to rank 0)
  bit for bit the one-process step's, in both ``cdis_ratio_mode``s at ratio
  2 and under ``z_mode="per_phase"``. The metrics agree to rtol 1e-6, not
  bit for bit: a loss metric sums over members, and the one-process step
  sums the (N, N) pair grid of ``council_dis_loss`` (and the means over
  members of the mask and recon_s losses) in one reduction, the shards in
  two (their m = N/K members, then the sum over ``council``). Measured:
  at most 1.01e-7 relative. The gradients are not affected: each member's
  gradient comes from its own terms;
* data parallelism (D = 2, and D = 2 x K = 2): the JAX package's tolerances
  (tests/test_council_shard.py): metrics rtol 2e-3 / atol 1e-4, parameters
  within 5e-4 after one step at lr 1e-4, and three steps at 30x the lr that
  track the one-process run; the data-axis replicas bit-equal on every rank
  after every step;
* ``det_data_reduction`` at D = 2: the replicas bit-equal, and two runs of
  the layout bit-equal;
* the compiled step (``compile_step``) over the CPU stand-in of the capture
  context, at D = 2, K = 2 (also ``every_kth`` at k = 2: two graphs) and
  D = 2 x K = 2 (with and without ``det_data_reduction``): every metric,
  parameter, buffer and Adam moment, every sample and snapshot taken
  between its steps, bit for bit the eager step's from the same init,
  batch and z. Gloo ranks cannot capture; on the card the same protocol
  replays graphs that hold the NCCL collectives (tests/test_torch_cuda.py,
  chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from councilx_torch.config import Config
from councilx_torch.parallel.mesh import (local_devices, make_member_mesh,
                                          make_mesh)
from councilx_torch.train.trainer import CouncilTrainer
from torch_dist_worker import launch

RAW = {
    "batch_size": 4, "lr": 1e-4, "weight_decay": 1e-4, "gan_w": 1.0,
    "recon_x_w": 10.0, "recon_s_w": 1.0, "recon_c_w": 1.0,
    "compute_dtype": "float32", "parity_mode": True,
    "skip_nonfinite_updates": True,
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
            "n_res": 2},
    "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
    "council": {"council_size": 4, "council_w": 0.2},
    "focus_loss": {"focus_enabled": True},
    "data": {"crop_image_height": 32, "crop_image_width": 32},
}
RATIO2 = {"council_dis_relative_iteration": 2}
VARIANTS = {
    "default": {},
    "k_per_step": {"council": {**RATIO2, "cdis_ratio_mode": "k_per_step"}},
    "every_kth": {"council": {**RATIO2, "cdis_ratio_mode": "every_kth"}},
    "per_phase": {"z_mode": "per_phase"},
    "lr30": {"lr": 3e-3},
}
STEPS = {"lr30": 3}
# the sums over members regrouped (module docstring): measured 1.01e-7
MEMBER_METRIC_RTOL = 1e-6


def raw(variant):
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in RAW.items()}
    for k, v in VARIANTS[variant].items():
        out[k] = {**out[k], **v} if isinstance(v, dict) else v
    return out


def run(variant, council=1, name=None, **extra):
    r = raw(variant)
    r.update(extra)
    return {"name": name or variant, "raw": r, "council": council,
            "steps": STEPS.get(variant, 2)}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The one-process steps of every variant."""
    return launch({"scenario": "steps", "runs": [run(v) for v in VARIANTS]},
                  1, tmp_path_factory.mktemp("refs"))[0]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    runs = [run(v, council=2, name=f"K2-{v}")
            for v in ("default", "k_per_step", "every_kth", "per_phase")]
    runs += [run("default", name="D2-default"),
             run("lr30", name="D2-lr30"),
             run("default", name="det-a", det_data_reduction=True),
             run("default", name="det-b", det_data_reduction=True)]
    return launch({"scenario": "steps", "runs": runs}, 2,
                  tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    runs = [run("default", council=4, name="K4-default"),
            run("per_phase", council=4, name="K4-per_phase"),
            run("default", council=2, name="D2K2-default"),
            run("lr30", council=2, name="D2K2-lr30")]
    return launch({"scenario": "steps", "runs": runs}, 4,
                  tmp_path_factory.mktemp("four"))


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """Each layout's eager and compiled steps, by run name."""
    tmp = tmp_path_factory.mktemp("compiled")
    two = launch({"scenario": "compiled", "runs": [
        {**run("default", name="D2"), "steps": 4},
        {**run("default", council=2, name="K2"), "steps": 4},
        {**run("every_kth", council=2, name="K2-every_kth"), "steps": 6}]},
        2, tmp)
    four = launch({"scenario": "compiled", "runs": [
        {**run("default", council=2, name="D2K2"), "steps": 4},
        {**run("default", council=2, name="D2K2-det",
               det_data_reduction=True), "steps": 4}]}, 4, tmp)
    return {name: [r[name] for r in ranks] for ranks in (two, four)
            for name in ranks[0]}


@pytest.mark.parametrize("name,graphs", [
    ("D2", 1), ("K2", 1), ("K2-every_kth", 2), ("D2K2", 1), ("D2K2-det", 1)])
def test_compiled_step_is_the_eager_step(compiled, name, graphs):
    for rank, out in enumerate(compiled[name]):
        eager, comp = out["eager"], out["compiled"]
        steps = len(eager["metrics"])
        assert comp["graphs"] == graphs
        # each step shape's first call is its eager warm-up, then one
        # capture each, and every later call a replay
        assert comp["replays"] == steps - graphs
        assert comp["metrics"] == eager["metrics"], rank
        for a, b in zip(comp["local"], eager["local"]):
            assert all(torch.equal(x, y) for (_, x), (_, y)
                       in zip(flat(a), flat(b)))
        for a, b in zip(comp["samples"], eager["samples"]):
            assert torch.equal(a, b)
        for a, b in zip(comp["snapshots"], eager["snapshots"]):
            if rank == 0:
                assert_bit_equal(a, b)
            else:
                assert a is None and b is None


def _layouts(request, name):
    return request.getfixturevalue("four" if name.startswith(("K4", "D2K2"))
                                   else "two")


def flat(payload):
    """(name, tensor) of every parameter, buffer and Adam moment and count
    of a snapshot payload, in the one-process layout's order."""
    out = []
    for d in sorted(payload["params"]):
        for g in ("gen", "dis", "cdis"):
            for i, sd in enumerate(payload["params"][d][g]):
                out += [(f"{d}/{g}/{i}/{k}", v) for k, v in sd.items()]
    for g in ("gen", "dis", "cdis"):
        for key in ("mu", "nu"):
            out += [(f"opt/{g}/{key}/{i}", v)
                    for i, v in enumerate(payload["opt"][g][key])]
        out.append((f"opt/{g}/count", payload["opt"][g]["count"]))
    return out


def members(payload, off, n):
    """The params of members [off, off + n) of a one-process payload."""
    return [(k, v) for k, v in flat(payload) if not k.startswith("opt/")
            and off <= int(k.split("/")[2]) < off + n]


def assert_bit_equal(got, want):
    a, b = flat(got), flat(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    bad = [k for (k, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
    assert not bad, bad[:8]
    assert got["step"] == want["step"]
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("name", ["K2-default", "K2-k_per_step",
                                  "K2-every_kth", "K2-per_phase",
                                  "K4-default", "K4-per_phase"])
def test_member_parallel_is_the_one_process_step(request, refs, name):
    ranks = _layouts(request, name)
    variant = name.split("-", 1)[1]
    got, want = ranks[0][name], refs[variant]
    assert_bit_equal(got["snapshot"], want["snapshot"])
    assert all(r[name]["snapshot"] is None for r in ranks[1:])
    k = len(ranks)
    for r, out in enumerate(ranks):
        assert out[name]["layout"] == (0, 1, r * 4 // k, 4 // k)
        for a, b in zip(out[name]["metrics"], want["metrics"]):
            assert set(a) == set(b)
            for key in b:
                np.testing.assert_allclose(a[key], b[key],
                                           rtol=MEMBER_METRIC_RTOL,
                                           err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", ["D2-default", "D2K2-default"])
def test_data_parallel_matches_the_one_process_step(request, refs, name):
    ranks = _layouts(request, name)
    want = refs["default"]
    for out in ranks:
        d_idx, d_size, off, n = out[name]["layout"]
        assert d_size == 2
        for a, b in zip(out[name]["metrics"], want["metrics"]):
            assert set(a) == set(b)
            for key in b:
                np.testing.assert_allclose(a[key], b[key], rtol=2e-3,
                                           atol=1e-4, err_msg=key)
        # Adam's first update is ~+-lr whatever the gradient, so one step
        # at lr 1e-4 leaves every parameter within 5e-4
        got = members(out[name]["local"][0], 0, n)
        ref = members(want["local"][0], off, n)
        assert [k.split("/", 3)[3] for k, _ in got] == \
            [k.split("/", 3)[3] for k, _ in ref]
        worst = max(float((x - y).abs().max())
                    for (_, x), (_, y) in zip(got, ref))
        assert worst < 5e-4, (name, worst)


@pytest.mark.parametrize("name", ["D2-lr30", "D2K2-lr30"])
def test_data_parallel_tracks_at_30x_lr(request, refs, name):
    """Three steps at lr 3e-3: a wrong gradient compounds far past these
    bounds, while the benign Adam sign flips of rounding-noise gradients
    touch few coordinates (the JAX test's statistics)."""
    lr = 3e-3
    want = refs["lr30"]
    for out in _layouts(request, name):
        _, _, off, n = out[name]["layout"]
        got = members(out[name]["local"][-1], 0, n)
        ref = members(want["local"][-1], off, n)
        for grp in ("gen", "dis", "cdis"):
            diffs = np.concatenate([
                (x - y).abs().numpy().ravel()
                for (k, x), (_, y) in zip(got, ref) if f"/{grp}/" in k])
            assert diffs.mean() < lr / 10, (name, grp, diffs.mean())
            assert (diffs > lr / 2).mean() < 0.01, (name, grp)


@pytest.mark.parametrize("name", ["D2-default", "D2-lr30", "D2K2-default",
                                  "D2K2-lr30", "det-a"])
def test_data_replicas_stay_bit_equal(request, name):
    """The ranks of one council slice hold the same members: bit-equal
    after every step, and the same metrics on every rank."""
    ranks = _layouts(request, name)
    by_slice = {}
    for out in ranks:
        _, _, off, _ = out[name]["layout"]
        by_slice.setdefault(off, []).append(out[name])
    assert all(len(v) == 2 for v in by_slice.values())
    for a, b in by_slice.values():
        for sa, sb in zip(a["local"], b["local"]):
            assert all(torch.equal(x, y) for (_, x), (_, y)
                       in zip(flat(sa), flat(sb)))
        assert a["metrics"] == b["metrics"]
    assert all(out[name]["metrics"] == ranks[0][name]["metrics"]
               for out in ranks)


def test_det_data_reduction_is_reproducible(two, refs):
    """Two runs of the order-fixed reduction: bit-equal states and
    metrics; and within the data-parallel tolerance of one process."""
    for out in two:
        a, b = out["det-a"], out["det-b"]
        assert a["metrics"] == b["metrics"]
        for sa, sb in zip(a["local"], b["local"]):
            assert all(torch.equal(x, y) for (_, x), (_, y)
                       in zip(flat(sa), flat(sb)))
        assert a["layout"][1] == 2
        for m, w in zip(a["metrics"], refs["default"]["metrics"]):
            for key in w:
                np.testing.assert_allclose(m[key], w[key], rtol=2e-3,
                                           atol=1e-4, err_msg=key)


def test_snapshot_of_a_data_parallel_run_is_rank_0s(two):
    assert_bit_equal(two[0]["D2-default"]["snapshot"],
                     two[0]["D2-default"]["local"][-1])
    assert two[1]["D2-default"]["snapshot"] is None


def test_local_zs_are_the_global_draws_block():
    cfg = Config.from_dict({**raw("per_phase"), "council": {
        "council_size": 4, "council_w": 0.2, **RATIO2,
        "cdis_ratio_mode": "k_per_step"}})
    t = CouncilTrainer(cfg, device="cpu")
    state = t.init_state(0)
    zs = t.draw_zs(state, 4)
    t.member_offset, t.n_local, t.data_index, t.data_size = 2, 2, 1, 2
    local = t._local_zs(zs)
    assert sorted(local) == sorted(zs) == ["cdis", "cdis_repeat", "dis",
                                           "gen"]
    for key in ("gen", "cdis", "dis"):
        assert torch.equal(local[key]["a2b"], zs[key]["a2b"][2:4, 2:4])
    assert torch.equal(local["cdis_repeat"][0]["a2b"],
                       zs["cdis_repeat"][0]["a2b"][2:4, 2:4])


def test_grids_refuse_what_the_jax_meshes_refuse():
    # one process, no process group: a grid of more ranks names torchrun
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2)
    with pytest.raises(ValueError, match="need 3 devices"):
        make_member_mesh(3, devices=["cpu", "cpu"])
    grid = make_member_mesh(2, devices=["cpu"] * 4, data_parallel=2)
    assert grid.axis_names == ("data", "council")
    assert grid.shape == {"data": 2, "council": 2}
    assert make_member_mesh(2, devices=["cpu"] * 2).shape == {"council": 2}
    assert local_devices(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="need 64 devices"):
            local_devices(64)
