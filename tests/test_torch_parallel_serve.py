"""The port's serving over several devices, on the CPU: the device lists
name the CPU more than once, as a one-card machine names its card.

* ``ShardedTranslator`` over [cpu, cpu] gives, bit for bit, what the
  one-device ``Translator`` gives on each slice at the slice's batch, in
  ``quant: none`` and ``w8a8_static`` (each copy quantizes its own weights
  from the same calibration);
* ``MemberShardedTranslator`` over 2 and 4 "devices", and over a 2 x 2
  grid, gives what ``translate_all_*`` gives, member by member, at the
  slice's batch;
* the engine's buckets are multiples of the data size, and it refuses what
  the JAX engine refuses;
* ``cli.serve.build_engine`` and ``cli.translate`` take
  ``--data_parallel``/``--member_parallel`` with the JAX CLIs' rules;
* their captured calls (one per device, ``ShardedCall``) over the CPU
  stand-in of the capture context (tests/test_torch_capture_helpers.py):
  every method each serves, on two inputs, is its eager call, and the
  engine routes every bucket through them when its ``graphs`` is set,
  returning what the eager engine returns: D = 2 in ``none`` and
  ``w8a8_static``, grids (1, 2), (1, 4) and (2, 2).
"""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx_torch.ckpt.torch_convert import port_quant_stats_to_tree
from councilx_torch.cli import serve
from councilx_torch.cli import translate as translate_cli
from councilx_torch.config import Config
from councilx_torch.inference.server import BatchingEngine, _bucket_ladder
from councilx_torch.inference.translate import (MemberShardedTranslator,
                                                ShardedCall,
                                                ShardedTranslator,
                                                Translator)
from councilx_torch.parallel.mesh import local_devices, make_member_mesh
from councilx_torch.tools.calibrate_quant import calibrate
from test_torch_capture_helpers import use_stand_in

HW, B, S, N = 32, 4, 3, 4
RAW = {"gen": {"dim": 8, "mlp_dim": 16, "style_dim": S, "n_downsample": 2,
               "n_res": 2},
       "council": {"council_size": N}, "compute_dtype": "float32",
       "focus_loss": {"focus_enabled": True},
       "crop_image_height": HW, "crop_image_width": HW, "new_size": HW}


@pytest.fixture(scope="module")
def council():
    """N members' state dicts, a batch, its codes and a calibration."""
    tr = Translator(Config.from_dict(RAW), device="cpu")
    sds = [g.state_dict() for g in tr.init_members(N, seed=0)]
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    x_u8 = r.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)
    z = r.standard_normal((B, S)).astype(np.float32)
    zn = r.standard_normal((N, B, S)).astype(np.float32)
    gen = tr.make_gen(quant="w8a8_calib")
    gen.load_state_dict(sds[0], strict=True)
    stats = port_quant_stats_to_tree(
        calibrate(tr, gen, [x], num_style=2, seed=0), tr.cfg)
    return sds, x, x_u8, z, zn, stats


def _cfg(**over):
    return Config.from_dict({**RAW, **over})


@pytest.mark.parametrize("quant", ["none", "w8a8_static"])
def test_sharded_translator_is_the_one_device_call_per_slice(council,
                                                             quant):
    sds, x, x_u8, z, _, stats = council
    stats = stats if quant == "w8a8_static" else None
    cfg = _cfg(quant=quant)
    sharded = ShardedTranslator(cfg, ["cpu", "cpu"], quant_stats=stats)
    one = Translator(cfg, quant_stats=stats, device="cpu")
    members, gens = sharded.load_members(sds), one.load_members(sds)
    assert len(members) == N and all(len(m) == 2 for m in members)
    h = B // 2
    halves = [slice(0, h), slice(h, B)]

    def per_slice(fn, *arrays):
        outs = [fn(*(a[s] for a in arrays)) for s in halves]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    got = sharded.translate_u8io_device(members, x_u8, z=z, member=2)
    want = per_slice(lambda a, b: one.translate_u8io_device(
        gens, a, z=b, member=2), x_u8, z)
    assert torch.equal(got, want)
    got = sharded.translate_u8_device(members[1], x, z=z)
    want = per_slice(lambda a, b: one.translate_u8_device(gens[1], a, z=b),
                     x, z)
    assert torch.equal(got, want)
    images, masks = sharded.translate(members, x, z=z, member=0)
    w_images, w_masks = per_slice(lambda a, b: one.translate(
        gens, a, z=b, member=0), x, z)
    assert torch.equal(images, w_images) and torch.equal(masks, w_masks)
    # z drawn from the generator as the one-device call draws it
    got = sharded.translate_u8(members, x, rng=torch.Generator()
                               .manual_seed(3), member=0)
    zr = torch.randn((B, S), generator=torch.Generator().manual_seed(3))
    want = per_slice(lambda a, b: one.translate_u8_device(
        gens, a, z=b, member=0), x, zr)
    np.testing.assert_array_equal(got, want.numpy())
    # the first copy's style codes
    assert torch.equal(sharded.encode_style(members, x, member=3),
                       one.encode_style(gens, x, member=3))
    with pytest.raises(ValueError, match="not divisible"):
        sharded.translate_u8io_device(members, x_u8[:3], z=z[:3], member=0)
    # random members: Translator.init_members's weights on every device
    drawn = sharded.init_members(N, seed=0)
    assert all(torch.equal(copy.state_dict()[k], sd[k])
               for member, sd in zip(drawn, sds) for copy in member
               for k in sd)
    sharded.close()


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_member_sharded_translator_is_translate_all(council, shape):
    sds, x, x_u8, z, zn, stats = council
    d, k = shape
    cfg = _cfg()
    grid = make_member_mesh(k, devices=["cpu"] * (d * k), data_parallel=d)
    sharded = MemberShardedTranslator(cfg, grid)
    one = Translator(cfg, device="cpu")
    members, gens = sharded.load_members(sds), one.load_members(sds)
    assert sharded.data_size == d and len(members) == N
    rows = [slice(i * B // d, (i + 1) * B // d) for i in range(d)]

    def per_slice(fn, **args):
        outs = [fn(**{k_: (a[:, r] if k_ == "zn" else a[r])
                      for k_, a in args.items()}) for r in rows]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o, dim=1) for o in zip(*outs))
        return torch.cat(outs, dim=1)

    got = sharded.translate_all_u8io_device(members, x_u8, z)
    want = per_slice(lambda x, z: one.translate_all_u8io_device(gens, x, z),
                     x=x_u8, z=z)
    assert got.shape == (N, B, HW, HW, 3) and torch.equal(got, want)
    got = sharded.translate_all_u8_device(members, x, z)
    want = per_slice(lambda x, z: one.translate_all_u8_device(gens, x, z),
                     x=x, z=z)
    assert torch.equal(got, want)
    images, masks = sharded.translate_all_members(members, x, z=zn)
    w_images, w_masks = per_slice(
        lambda x, zn: one.translate_all_members(gens, x, z=zn), x=x, zn=zn)
    assert torch.equal(images, w_images) and torch.equal(masks, w_masks)
    with pytest.raises(ValueError, match="calibrated per member"):
        MemberShardedTranslator(_cfg(quant="w8a8_static"), grid,
                                quant_stats=stats)
    sharded.close()


def test_member_sharded_translator_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="not divisible"):
        MemberShardedTranslator(_cfg(), make_member_mesh(
            3, devices=["cpu"] * 3))


def test_bucket_ladder_takes_the_data_size():
    assert _bucket_ladder(64) == [1, 2, 4, 8, 16, 32, 64]
    assert _bucket_ladder(64, 2) == [2, 4, 8, 16, 32, 64]
    assert _bucket_ladder(48, 4) == [4, 8, 16, 32, 48]


def test_engine_serves_over_the_sharded_translators(council):
    sds, x, x_u8, z, _, _ = council
    cfg = _cfg()
    sharded = ShardedTranslator(cfg, ["cpu", "cpu"])
    member = sharded.load_members(sds)[1]
    with pytest.raises(ValueError, match="multiple of the serving data"):
        BatchingEngine(sharded, member, (HW, HW), max_batch=3)
    with pytest.raises(ValueError, match="MemberShardedTranslator"):
        BatchingEngine(sharded, sharded.load_members(sds), (HW, HW),
                       max_batch=4, all_members=True)
    engine = BatchingEngine(sharded, member, (HW, HW), max_batch=4,
                            max_delay_ms=5000.0)
    assert engine.buckets == [2, 4]
    engine.start()
    try:
        futures = [engine.submit(x_u8[i], z=z[i]) for i in range(B)]
        got = np.stack([f.result(timeout=60) for f in futures])
    finally:
        engine.stop()
    # one bucket of 4 (the engine waits for max_batch): each request
    # against the one-device call on its half of it
    assert engine.snapshot_stats()["batch_size_histogram"] == {4: 1}
    one = Translator(cfg, device="cpu")
    gen = one.load_members(sds)[1]
    want = torch.cat([one.translate_u8io_device(gen, x_u8[s], z=z[s])
                      for s in (slice(0, 2), slice(2, 4))]).numpy()
    np.testing.assert_array_equal(got, want)

    members = MemberShardedTranslator(cfg, make_member_mesh(
        2, devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="all_members=True"):
        BatchingEngine(members, members.load_members(sds)[0], (HW, HW))
    engine = BatchingEngine(members, members.load_members(sds), (HW, HW),
                            max_batch=2, all_members=True)
    assert engine.n_members == N and engine.buckets == [1, 2]
    engine.start()
    try:
        out = engine.translate_sync(x_u8[0], z=z[0])
    finally:
        engine.stop()
    want = one.translate_all_u8io_device(one.load_members(sds), x_u8[:1],
                                         z[:1])[:, 0].numpy()
    np.testing.assert_array_equal(out, want)
    sharded.close()
    members.close()


@pytest.fixture(scope="module")
def checkpoint(council, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    path = str(tmp / "gen.pt")
    torch.save({"a2b": list(council[0])}, path)
    cfg_path = tmp / "run.yaml"
    cfg_path.write_text(yaml.safe_dump(RAW))
    return tmp, path, str(cfg_path)


def test_serve_builds_the_sharded_engines(checkpoint):
    _, path, _ = checkpoint
    cfg = _cfg()
    engine = serve.build_engine(cfg, path, "1", "a2b", 4, 5.0,
                                data_parallel=2, warmup=False, device="cpu")
    try:
        assert isinstance(engine.translator, ShardedTranslator)
        assert engine.buckets == [2, 4]
    finally:
        engine.stop()
    for kwargs, grid in (({"member_parallel": 2}, {"council": 2}),
                         ({"data_parallel": 2}, {"council": 2}),
                         ({"member_parallel": 2, "data_parallel": 2},
                          {"data": 2, "council": 2})):
        engine = serve.build_engine(cfg, path, "all", "a2b", 4, 5.0,
                                    warmup=False, device="cpu", **kwargs)
        try:
            assert isinstance(engine.translator, MemberShardedTranslator)
            assert engine.translator.grid.shape == grid
            assert engine.n_members == N
        finally:
            engine.stop()


@pytest.mark.parametrize("kwargs,member,match", [
    ({"member_parallel": 3}, "all", "must divide council_size"),
    ({"data_parallel": 3}, "all", "must divide council_size"),
    ({"data_parallel": 64, "device": "cuda"}, "0", "need 64 devices"),
    ({"data_parallel": 2}, "0", "multiple of --data_parallel")])
def test_serve_refuses_layouts_it_cannot_serve(checkpoint, kwargs, member,
                                               match):
    _, path, _ = checkpoint
    kwargs = {"device": "cpu", **kwargs}
    max_batch = {"need 64 devices": 64, "multiple of --data_parallel": 3
                 }.get(match, 4)
    with pytest.raises(SystemExit, match=match):
        serve.build_engine(_cfg(), path, member, "a2b", max_batch, 5.0,
                           warmup=False, **kwargs)


def test_translate_cli_shards_each_batch(checkpoint, monkeypatch):
    tmp, path, cfg_path = checkpoint
    folder = tmp / "in"
    folder.mkdir()
    r = np.random.default_rng(2)
    for i in range(5):      # batch 4: a padded tail batch
        Image.fromarray(r.integers(0, 256, (40, 36, 3), dtype=np.uint8)
                        ).save(folder / f"img{i}.jpg")
    saved = {}
    orig = Image.Image.save

    def save(self, fp, *a, **k):
        saved[os.path.basename(str(fp))] = np.asarray(self).copy()
        return orig(self, fp, *a, **k)

    monkeypatch.setattr(Image.Image, "save", save)
    common = ["--config", cfg_path, "--checkpoint", path, "--input_folder",
              str(folder), "--member", "all", "--device", "cpu"]
    runs = {}
    for name, extra in (("one", ["--batch_size", "4"]),
                        ("two", ["--batch_size", "4",
                                 "--data_parallel", "2"])):
        saved.clear()
        assert translate_cli.main(common + extra + [
            "--output_folder", str(tmp / name)]) == 5
        runs[name] = dict(saved)
    assert sorted(runs["one"]) == sorted(runs["two"]) == sorted(
        f"img{i}_m{m}.jpg" for i in range(5) for m in range(N))
    # the same z draws; each shard translates 2 of the batch's 4 rows
    for name, want in runs["one"].items():
        assert np.array_equal(runs["two"][name], want), name
    with pytest.raises(SystemExit, match="not divisible"):
        translate_cli.main(common + ["--batch_size", "3", "--data_parallel",
                                     "2", "--output_folder", "unused"])


# the layouts served captured: (D, K, quant); K = 0 is ShardedTranslator
CAPTURED_LAYOUTS = {"D2-none": (2, 0, "none"),
                    "D2-w8a8_static": (2, 0, "w8a8_static"),
                    "grid-1x2": (1, 2, "none"), "grid-1x4": (1, 4, "none"),
                    "grid-2x2": (2, 2, "none")}


def _layout(council, name):
    """The layout's translator over the CPU named D x K times, its
    members, and what an engine serves (one member or the council)."""
    sds, *_, stats = council
    d, k, quant = CAPTURED_LAYOUTS[name]
    cfg = _cfg(quant=quant)
    if k == 0:
        tr = ShardedTranslator(cfg, local_devices(d, "cpu"), quant_stats=(
            stats if quant == "w8a8_static" else None))
        members = tr.load_members(sds)
        return tr, members, members[1]
    tr = MemberShardedTranslator(cfg, make_member_mesh(
        k, devices=local_devices(d * k, "cpu"), data_parallel=d))
    members = tr.load_members(sds)
    return tr, members, members


@pytest.mark.parametrize("name", sorted(CAPTURED_LAYOUTS))
def test_sharded_captured_calls_are_the_eager_calls(monkeypatch, council,
                                                    name):
    use_stand_in(monkeypatch.setattr)
    _, x, x_u8, z, zn, _ = council
    tr, _, params = _layout(council, name)
    r = np.random.default_rng(4)
    for method in tr.served:
        call = tr.captured(method, params, B, (HW, HW))
        assert isinstance(call, ShardedCall)
        assert len(call.calls) == len(tr._per_device)
        kept = None
        for i in range(2):
            xi = (x_u8 if "u8io" in method else x) if i == 0 else (
                r.integers(0, 256, x_u8.shape, dtype=np.uint8)
                if "u8io" in method else
                r.uniform(-1, 1, x.shape).astype(np.float32))
            zi = zn if method == "translate_all_members" else z
            zi = zi if i == 0 else r.standard_normal(zi.shape).astype(
                np.float32)
            got = call(torch.from_numpy(xi), torch.from_numpy(zi))
            want = getattr(tr, method)(params, xi, zi)
            got, want = ((got, want) if isinstance(got, tuple)
                         else ((got,), (want,)))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            if i == 0:
                kept, first = got, tuple(t.clone() for t in got)
        assert all(torch.equal(a, b) for a, b in zip(kept, first))
        assert call.replays == 2
        assert tr.captured(method, params, B, (HW, HW)) is call
    with pytest.raises(ValueError, match="serves"):
        tr.captured("translate_u8io_device" if "grid" in name else
                    "translate_all_u8io_device", params, B, (HW, HW))
    tr.close()


@pytest.mark.parametrize("name", sorted(CAPTURED_LAYOUTS))
def test_engine_routes_sharded_translators_through_captured(
        monkeypatch, council, name):
    """As test_torch_graphs.py's one-device engine test: the captured
    route, over the stand-in, returns the eager engine's results, and
    every bucket is one captured call per device."""
    use_stand_in(monkeypatch.setattr)
    _, _, x_u8, _, _, _ = council
    tr, _, params = _layout(council, name)
    all_members = "grid" in name
    outs = {}
    for graphs in (False, True):
        eng = BatchingEngine(tr, params, (HW, HW), max_batch=4,
                             max_delay_ms=50.0, all_members=all_members)
        assert eng.graphs is False
        eng.graphs = graphs
        eng.start()
        try:
            eng.warmup()
            outs[graphs] = [f.result(timeout=120) for f in
                            [eng.submit(x, seed=i)
                             for i, x in enumerate(x_u8)]]
        finally:
            eng.stop()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    # keyed (method, members, batch, hw): one call per bucket
    assert sorted(key[2] for key in tr._captured) == eng.buckets
    calls = [c for _, c in tr._captured.values()]
    assert sum(c.replays for c in calls) == eng.replays > len(eng.buckets)
    assert all(len(t._captured) == len(eng.buckets) for t in tr._per_device)
    tr.load_members(council[0])
    assert not tr._captured
    tr.close()
