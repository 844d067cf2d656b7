"""W8A8 serving in the port vs the JAX package, on the CPU at a tiny size
(32px, dim 8, 2 resblocks, council-2): the phase upsample, the quantized
generator in every mode and scope, the calibration and its .npz in both
directions, the Translator's gating, the batching engine, the serve CLI
and the quality tool.

The JAX council is initialised from a seed and carried into the port by
the existing converters; inputs and style codes come from numpy seeds and
go into both sides. Compute is f32 (``compute_dtype: float32``,
``parity_mode: false``), where the port's kernels run their plain
versions. The quantized outputs differ only where an activation code
flipped: a flip moves one code by one step, from summation-order
differences of ~1e-7 upstream that land on a rounding boundary; the test
reports their count at the first quantized conv.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from councilx.ckpt.manager import load_params_npz as jload_params_npz
from councilx.ckpt.manager import save_params_npz as jsave_params_npz
from councilx.config import Config as JConfig
from councilx.inference.translate import Translator as JTranslator
from councilx.nn.generator import AdaINGen as JAdaINGen
from councilx.ops.upsample_conv import upsample2x_conv5x5 as jupsample
from councilx_torch.ckpt.manager import (load_params_npz,
                                         params_to_state_dicts,
                                         save_params_npz)
from councilx_torch.ckpt.torch_convert import (port_quant_stats_to_tree,
                                              quant_stat_names,
                                              quant_stats_to_port)
from councilx_torch.cli import serve
from councilx_torch.config import Config
from councilx_torch.inference.server import BatchingEngine
from councilx_torch.inference.translate import Translator
from councilx_torch.ops import quant as q_ops
from councilx_torch.ops.upsample_conv import (upsample2x_conv5x5_reference,
                                              upsample2x_conv5x5_w8a8)
from councilx_torch.tools import calibrate_quant, quant_quality

torch.set_num_threads(2)

HW, B, S, N = 32, 3, 3, 2
RAW = {"gen": {"dim": 8, "mlp_dim": 16, "style_dim": S, "n_downsample": 2,
               "n_res": 2},
       "council": {"council_size": N}, "compute_dtype": "float32",
       "crop_image_height": HW, "crop_image_width": HW, "new_size": HW}
# the generator's outputs in [-1, 1]: code flips upstream move a pixel by
# up to ~1e-3 (one code, through the rest of the network), rarely more
TOL_MEAN, TOL_MAX = 1e-4, 1e-2
MODES = ["w8a8", "w8a8_static"]
ROUTES = [("resblocks", True), ("heavy", True), ("heavy", False)]


def _raw(**kw):
    return {**RAW, **kw}


def _jax_stats(params0, raw, x, zs):
    """The JAX calibration pass over (x, each z of zs): its quant_stats."""
    gen = JTranslator(JConfig.from_dict(raw)).gen.copy(quant="w8a8_calib")
    stats = gen.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, HW, HW, 3)))["quant_stats"]
    c, upd = gen.apply({"params": params0, "quant_stats": stats},
                       jnp.asarray(x), method=JAdaINGen.encode_content,
                       mutable=["quant_stats"])
    stats = upd["quant_stats"]
    for z in zs:
        _, upd = gen.apply({"params": params0, "quant_stats": stats}, c,
                           jnp.asarray(z), method=JAdaINGen.decode,
                           mutable=["quant_stats"])
        stats = upd["quant_stats"]
    return jax.device_get(stats)


@pytest.fixture(scope="module")
def council():
    jtr = JTranslator(JConfig.from_dict(RAW))
    init = jax.jit(jax.vmap(jtr.gen.init, in_axes=(0, None)))
    stacked = jax.device_get(init(jax.random.split(jax.random.PRNGKey(0), N),
                                  jnp.zeros((1, HW, HW, 3)))["params"])
    params0 = jax.tree_util.tree_map(lambda a: a[0], stacked)
    sds = params_to_state_dicts(stacked, Config.from_dict(RAW))
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32)
    z = r.standard_normal((B, S)).astype(np.float32)
    zs = r.standard_normal((2, B, S)).astype(np.float32)
    # one calibration per scope, by the JAX package, shared by both sides
    stats = {scope: _jax_stats(params0, _raw(quant_scope=scope), x, zs)
             for scope in ("resblocks", "heavy")}
    return stacked, params0, sds, x, z, zs, stats


def _translators(raw, stats, sds):
    jtr = JTranslator(JConfig.from_dict(raw), quant_stats=stats)
    tr = Translator(Config.from_dict(raw), quant_stats=stats, device="cpu")
    return jtr, tr, tr.load_members(sds[:1])[0]


def test_phase_upsample_matches_jax():
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 6, 5, 16)).astype(np.float32)
    k = (r.standard_normal((5, 5, 16, 8)) * 0.1).astype(np.float32)
    bias = r.standard_normal(8).astype(np.float32)
    xt, kt, bt = (torch.from_numpy(a) for a in (x, k, bias))
    ref = upsample2x_conv5x5_reference(xt, kt, bt, "reflect")
    # per image, and a static scale covering max |x| (~3.3)
    for a_scale in (None, 0.03):
        got = upsample2x_conv5x5_w8a8(
            xt, kt, bt, "reflect",
            None if a_scale is None else torch.tensor(a_scale))
        want = jupsample(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                         "reflect", quant=True, engine="phase",
                         a_scale=None if a_scale is None
                         else jnp.asarray(a_scale, jnp.float32))
        want = np.asarray(want)
        assert got.shape == (2, 12, 10, 8)
        # the quantized interior bit for bit; the 2-pixel border strips are
        # f32 convs summed in another order: within 1e-6 of the largest
        np.testing.assert_array_equal(got.numpy()[:, 2:-2, 2:-2],
                                      want[:, 2:-2, 2:-2])
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-6 * np.abs(want).max())
        # close to the unquantized op, not equal to it
        err = float((got - ref).abs().max())
        assert 0 < err < 0.05 * float(ref.abs().max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scope,fuse", ROUTES)
def test_quantized_generator_matches_jax(council, mode, scope, fuse):
    _, params0, sds, x, z, _, stats = council
    raw = _raw(quant=mode, quant_scope=scope, fuse_upsample=fuse)
    jtr, tr, gen = _translators(raw, stats[scope] if mode == "w8a8_static"
                                else None, sds)
    want = np.asarray(jtr.translate(params0, jnp.asarray(x),
                                    z=jnp.asarray(z))[0])
    got = tr.translate(gen, x, z=z)[0].numpy()
    assert got.shape == (B, HW, HW, 3) and np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.mean() <= TOL_MEAN and d.max() <= TOL_MAX, (d.mean(), d.max())
    # the codes of the first quantized conv: the port's input against the
    # JAX block's, each quantized as its own mode does it
    first = ("enc_content", "Conv2dBlock_1") if scope == "heavy" else (
        "enc_content", "ResBlocks_0", "ResBlock_0", "Conv2dBlock_0")
    name = ("enc_content.model.1" if scope == "heavy"
            else "enc_content.model.3.model.0.model.0")
    seen = {}

    def grab(module, args):     # returns None: the input goes on unchanged
        seen["x"] = args[0]

    hook = dict(gen.named_modules())[name].register_forward_pre_hook(grab)
    try:
        tr.translate(gen, x, z=z)
    finally:
        hook.remove()
    jx = _jax_block_input(jtr, params0, x, first)
    a_scale = (None if mode == "w8a8" else
               torch.tensor(float(np.asarray(_leaf(stats[scope], first))))
               / 127.0)
    qp, _ = q_ops.quantize_act_reference(seen["x"], 0, "zero", a_scale)
    qj, _ = q_ops.quantize_act_reference(torch.from_numpy(np.array(jx)), 0,
                                         "zero", a_scale)
    flips = int((qp != qj).sum())
    print(f"{mode} {scope} fuse_upsample={fuse}: {flips} code flips of "
          f"{qp.numel()} at the first quantized conv; output mean "
          f"{d.mean():.3g} max {d.max():.3g}")
    assert flips <= 1e-3 * qp.numel()


def _leaf(tree, path):
    node = tree
    for key in path:
        node = node[key]
    return node["act_absmax"]


def _jax_block_input(jtr, params0, x, path):
    """The input of the JAX block at ``path``: the output of the module
    before it (capture_intermediates)."""
    prev = (("enc_content", "Conv2dBlock_0") if path[-1] == "Conv2dBlock_1"
            and len(path) == 2 else ("enc_content", "Conv2dBlock_2"))
    _, inter = jtr.gen.apply(jtr._vars(params0), jnp.asarray(x),
                             method=JAdaINGen.encode_content,
                             capture_intermediates=True)
    node = inter["intermediates"]
    for key in prev:
        node = node[key]
    return np.asarray(node["__call__"][0])


def _jax_calib_inputs(params0, raw, x, zs):
    """The JAX calibration pass with every quantized block's input per pass
    (from capture_intermediates: the output of the module before it), by
    the port's module names."""
    gen = JTranslator(JConfig.from_dict(raw)).gen.copy(quant="w8a8_calib")
    stats = gen.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, HW, HW, 3)))["quant_stats"]
    c, upd = gen.apply({"params": params0, "quant_stats": stats},
                       jnp.asarray(x), method=JAdaINGen.encode_content,
                       mutable=["quant_stats", "intermediates"],
                       capture_intermediates=True)
    enc = upd["intermediates"]["enc_content"]
    out = lambda node: np.asarray(node["__call__"][0])  # noqa: E731
    inputs = {"enc_content.model.1": [out(enc["Conv2dBlock_0"])],
              "enc_content.model.2": [out(enc["Conv2dBlock_1"])]}
    prev = out(enc["Conv2dBlock_2"])
    for r in range(2):
        rb = enc["ResBlocks_0"][f"ResBlock_{r}"]
        inputs[f"enc_content.model.3.model.{r}.model.0"] = [prev]
        inputs[f"enc_content.model.3.model.{r}.model.1"] = [
            out(rb["Conv2dBlock_0"])]
        prev = out(rb)
    stats = upd["quant_stats"]
    for z in zs:
        _, upd = gen.apply({"params": params0, "quant_stats": stats}, c,
                           jnp.asarray(z), method=JAdaINGen.decode,
                           mutable=["quant_stats", "intermediates"],
                           capture_intermediates=True)
        stats = upd["quant_stats"]
        dec = upd["intermediates"]["dec"]
        prev = np.asarray(c)
        for r in range(2):
            rb = dec["ResBlocks_0"][f"ResBlock_{r}"]
            inputs.setdefault(f"dec.model.0.model.{r}.model.0", []).append(
                prev)
            inputs.setdefault(f"dec.model.0.model.{r}.model.1", []).append(
                out(rb["Conv2dBlock_0"]))
            prev = out(rb)
        inputs.setdefault("dec.model.2", []).append(prev)
        inputs.setdefault("dec.model.4", []).append(out(dec["Conv2dBlock_0"]))
    return jax.device_get(stats), inputs


@pytest.mark.parametrize("scope,fuse", ROUTES)
def test_calibration_matches_jax_and_roundtrips(council, scope, fuse,
                                                tmp_path):
    """Each calibrated absmax equals JAX's to 1e-6 (relative), but where an
    activation code flipped in a quantized conv upstream of it in the same
    pass: a flip moves that conv's output by one code step, so the
    absmaxes after it are held to 1e-2 and counted."""
    _, params0, sds, x, _, zs, _ = council
    raw = _raw(quant_scope=scope, fuse_upsample=fuse)
    want, jax_inputs = _jax_calib_inputs(params0, raw, x, zs)
    tr = Translator(Config.from_dict(raw), device="cpu")
    gen = tr.make_gen(quant="w8a8_calib")
    gen.load_state_dict(sds[0], strict=True)
    blocks = gen.quant_blocks()
    port_inputs = {name: [] for name in blocks}
    hooks = [m.register_forward_pre_hook(
        lambda m, args, name=name: port_inputs[name].append(args[0]))
        for name, m in blocks.items()]
    try:
        calibrate_quant.observe(tr, gen, x, zs)
    finally:
        for h in hooks:
            h.remove()
    got = gen.quant_stats()
    cfg = Config.from_dict(raw)
    port_want = quant_stats_to_port(want, cfg)
    assert list(got) == list(blocks) and sorted(got) == sorted(port_want)
    assert len(got) == (12 if scope == "heavy" else 8)
    flipped, loose = False, []
    for name, v in got.items():       # in the order the passes run them
        rel = abs(float(v) - float(port_want[name])) / float(port_want[name])
        assert rel <= (1e-2 if flipped else 1e-6), (name, rel)
        if rel > 1e-6:
            loose.append(name)
        for xp, xj in zip(port_inputs[name], jax_inputs[name], strict=True):
            if xp.shape != xj.shape:     # the port upsampled before it
                xp = xp[:, ::2, ::2]
            qp, _ = q_ops.quantize_act_per_image(xp)
            qj, _ = q_ops.quantize_act_per_image(torch.from_numpy(
                np.array(xj)))
            flipped |= bool((qp != qj).any())
    print(f"{scope} fuse_upsample={fuse}: stats beyond 1e-6 after an "
          f"upstream code flip: {loose}")
    # the .npz both ways: JAX's file read by the port, the port's by JAX
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave_params_npz(jpath, want)
    assert quant_stats_to_port(load_params_npz(jpath), cfg).keys() == \
        port_want.keys()
    save_params_npz(ppath, port_quant_stats_to_tree(got, cfg))
    back = jload_params_npz(ppath)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_leaves(want)):
        name = [n for p, n in quant_stat_names(2, 2)
                if p == tuple(k.key for k in path)][0]
        assert float(a) == float(got[name])
        assert abs(float(a) - float(b)) <= 1e-2 * float(b)


def test_calibrate_tool_serves_in_both_packages(council, tmp_path):
    """The port's calibration tool over a folder: its .npz serves static
    quant in the port and in JAX's Translator, the two outputs within the
    generator tolerance."""
    from PIL import Image

    _, params0, sds, x, z, _, _ = council
    raw = _raw(quant_scope="heavy")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    ckpt = str(tmp_path / "gen.pt")
    torch.save({"a2b_0": sds[0]}, ckpt)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, img in enumerate(((x + 1) * 127.5).astype(np.uint8)):
        Image.fromarray(img).save(folder / f"{i}.png")
    out = str(tmp_path / "qs.npz")
    summary = calibrate_quant.main([
        "--config", str(cfg_path), "--checkpoint", ckpt, "--input_folder",
        str(folder), "--batch_size", "2", "--num_batches", "2",
        "--num_style", "2", "--out", out, "--device", "cpu"])
    assert summary["convs"] == 12 and summary["images"] == 4
    stats = jload_params_npz(out)
    raw_s = _raw(quant="w8a8_static", quant_scope="heavy")
    jtr, tr, gen = _translators(raw_s, stats, sds)
    want = np.asarray(jtr.translate(params0, jnp.asarray(x),
                                    z=jnp.asarray(z))[0])
    got = tr.translate(gen, x, z=z)[0].numpy()
    d = np.abs(got - want)
    assert d.mean() <= TOL_MEAN and d.max() <= TOL_MAX, (d.mean(), d.max())


def test_translator_gating_matches_jax(council):
    _, _, sds, _, _, _, stats = council
    # static without stats, and the calibration mode, are refused
    with pytest.raises(ValueError, match="calibrated stats"):
        Translator(Config.from_dict(_raw(quant="w8a8_static")), device="cpu")
    with pytest.raises(ValueError, match="calibration-pass"):
        Translator(Config.from_dict(_raw(quant="w8a8_calib")), device="cpu")
    # resblocks-scope stats do not cover heavy: the error names the scope
    with pytest.raises(ValueError, match="quant_scope='heavy'"):
        Translator(Config.from_dict(_raw(quant="w8a8_static",
                                         quant_scope="heavy")),
                   quant_stats=stats["resblocks"], device="cpu")
    with pytest.raises(ValueError, match="quant_scope='heavy'"):
        JTranslator(JConfig.from_dict(_raw(quant="w8a8_static",
                                           quant_scope="heavy")),
                    quant_stats=stats["resblocks"])
    # heavy stats cover the resblocks scope
    tr = Translator(Config.from_dict(_raw(quant="w8a8_static")),
                    quant_stats=stats["heavy"], device="cpu")
    gen = tr.load_members(sds[:1])[0]
    assert len(gen.quant_blocks()) == 8
    # a static block without its calibrated stat refuses to run
    bare = Translator(Config.from_dict(_raw(quant="w8a8_static")),
                      quant_stats=stats["resblocks"], device="cpu").make_gen()
    with pytest.raises(RuntimeError, match="calibrated stat"):
        bare.encode_content(torch.zeros(1, HW, HW, 3))
    # parity mode forces quant off
    tr = Translator(Config.from_dict(_raw(quant="w8a8", parity_mode=True)),
                    device="cpu")
    assert tr.quant == "none" and not tr.init_members(1, 0)[0].quant_blocks()


@pytest.mark.parametrize("mode", MODES)
def test_engine_equals_direct_calls_at_the_same_bucket(council, mode):
    """Per-image scales keep the bucket's padded rows out of the real ones;
    the engine's results equal a direct call on the same padded bucket."""
    _, _, sds, x, _, _, stats = council
    raw = _raw(quant=mode, quant_scope="heavy")
    tr = Translator(Config.from_dict(raw), device="cpu",
                    quant_stats=stats["heavy"] if mode == "w8a8_static"
                    else None)
    gen = tr.load_members(sds[:1])[0]
    x_u8 = ((x + 1) * 127.5).astype(np.uint8)
    engine = BatchingEngine(tr, gen, image_hw=(HW, HW), max_batch=4,
                            max_delay_ms=200.0)
    engine.start()
    try:
        futures = [engine.submit(x_u8[i], seed=5 + i) for i in range(B)]
        outs = [f.result(timeout=120) for f in futures]
        stats_e = engine.snapshot_stats()
    finally:
        engine.stop()
    assert stats_e["batch_size_histogram"] == {4: 1}
    bucket = np.zeros((4, HW, HW, 3), np.uint8)
    bucket[:B] = x_u8
    zb = np.zeros((4, S), np.float32)
    zb[:B] = [engine.make_z(5 + i) for i in range(B)]
    direct = tr.translate_u8io(gen, bucket, z=zb)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, direct[i])


def test_serve_builds_a_quantized_engine_and_refuses_ensemble_calibration(
        council, tmp_path):
    _, stacked, _, _, _, _, stats = council
    ckpt = str(tmp_path / "gen.npz")
    jsave_params_npz(ckpt, stacked)
    calib = str(tmp_path / "qs.npz")
    jsave_params_npz(calib, stats["resblocks"])
    cfg = Config.from_dict(_raw(quant="w8a8_static"))
    engine = serve.build_engine(cfg, ckpt, "0", "a2b", 2, 5.0,
                                calibration=calib, device="cpu")
    try:
        assert len(engine.params.quant_blocks()) == 8
        out = engine.translate_sync(np.zeros((HW, HW, 3), np.uint8), seed=1,
                                    timeout=120)
        assert out.shape == (HW, HW, 3)
    finally:
        engine.stop()
    with pytest.raises(SystemExit, match="cannot use --calibration"):
        serve.build_engine(cfg, ckpt, "all", "a2b", 2, 5.0,
                           calibration=calib, device="cpu")


def test_quality_tool_meets_the_jax_gate(council, tmp_path):
    _, stacked, _, _, _, _, stats = council
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(RAW))
    ckpt = str(tmp_path / "gen.npz")
    jsave_params_npz(ckpt, stacked)
    calib = str(tmp_path / "qs.npz")
    jsave_params_npz(calib, stats["resblocks"])
    results = quant_quality.compare(str(cfg_path), ckpt, 0, "a2b",
                                     ["w8a8", "w8a8_static"],
                                     calibration=calib, batch_size=2,
                                     num_batches=2, seed=0, device="cpu",
                                     sheet_path=str(tmp_path / "s.jpg"))
    for mode in ("w8a8", "w8a8_static"):
        m = results[mode]
        assert m["images"] == 4
        # tests/test_quant.py's bar for the JAX tool
        assert m["psnr_min_db"] > 20.0, m
        assert m["maxabs_u8"] < 128, m
        assert m["meanabs_u8"] < 8.0, m
    assert os.path.getsize(tmp_path / "s.jpg") > 0
    with pytest.raises(SystemExit, match="calibration"):
        quant_quality.compare(str(cfg_path), ckpt, 0, "a2b",
                              ["w8a8_static"], device="cpu")
