"""The port's serving slice vs the JAX package's, on configs/smoke_tiny.yaml.

The JAX Translator's council (2 members, initialised from a seed) is moved
into the port through its checkpoint formats; the same images and injected
style codes go through both translators. Then the port's BatchingEngine and
serve CLI are held to direct translator calls. fp32 on the CPU, where the
port's kernel sites run their plain versions.
"""

import http.client
import io
import json
import os
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.ckpt.manager import save_params_npz
from councilx.ckpt.torch_export import export_adain_gen, unstack_members
from councilx.config import load_config as jload_config
from councilx.inference.translate import Translator as JTranslator
from councilx_torch.ckpt.manager import (load_generator_state_dicts,
                                         params_to_state_dicts)
from councilx_torch.cli import serve
from councilx_torch.config import Config, load_config
from councilx_torch.inference.server import BatchingEngine
from councilx_torch.inference.translate import Translator

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_tiny.yaml")
N, B, S, HW = 2, 3, 3, 32


@pytest.fixture(scope="module")
def council():
    jcfg, cfg = jload_config(CONFIG), load_config(CONFIG)
    jtr = JTranslator(jcfg)
    dummy = jnp.zeros((1, HW, HW, 3), jnp.float32)
    stacked = jax.device_get(jax.jit(jax.vmap(jtr.gen.init, in_axes=(0, None)))(
        jax.random.split(jax.random.PRNGKey(0), N), dummy)["params"])
    tr = Translator(cfg, device="cpu")
    gens = tr.load_members(params_to_state_dicts(stacked, cfg))
    r = np.random.default_rng(0)
    x_u8 = r.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)
    x = (x_u8.astype(np.float32) - 127.5) / 127.5
    z = r.standard_normal((N, B, S)).astype(np.float32)
    return jtr, stacked, tr, gens, x_u8, x, z


def _levels(a, b):
    return int(np.abs(np.asarray(a).astype(np.int16)
                      - np.asarray(b).astype(np.int16)).max())


@pytest.mark.parametrize("member", [0, 1])
def test_translate_matches_jax(council, member):
    jtr, stacked, tr, gens, _, x, z = council
    jimg, jmask = jtr.translate(stacked, jnp.asarray(x),
                                z=jnp.asarray(z[member]), member=member)
    img, mask = tr.translate(gens, x, z=z[member], member=member)
    # fp32 through the whole generator; sums in another order
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), atol=1e-4)


def test_translate_u8io_matches_jax(council):
    jtr, stacked, tr, gens, x_u8, _, z = council
    want = jtr.translate_u8io(stacked, jnp.asarray(x_u8),
                              z=jnp.asarray(z[1]), member=1)
    got = tr.translate_u8io(gens, x_u8, z=z[1], member=1)
    assert got.dtype == np.uint8 and got.shape == (B, HW, HW, 3)
    # the same scale-clamp-round; an f32 difference of 1e-5 can still flip
    # one rounding
    assert _levels(got, want) <= 1


def test_translate_all_members_matches_jax(council):
    jtr, stacked, tr, gens, _, x, z = council
    jimg, jmask = jtr.translate_all_members(stacked, jnp.asarray(x),
                                            z=jnp.asarray(z))
    img, mask = tr.translate_all_members(gens, x, z=z)
    assert img.shape == (N, B, HW, HW, 3) and mask.shape == (N, B, HW, HW, 1)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), atol=1e-4)


def test_translate_all_u8io_matches_jax(council):
    jtr, stacked, tr, gens, x_u8, _, z = council
    want = jtr.translate_all_u8io_device(stacked, jnp.asarray(x_u8),
                                         jnp.asarray(z[0]))
    got = tr.translate_all_u8io_device(gens, x_u8, z[0])
    assert got.shape == (N, B, HW, HW, 3)
    assert _levels(got.numpy(), want) <= 1


@pytest.mark.parametrize("all_members,pipeline", [(False, True),
                                                  (True, True),
                                                  (False, False)])
def test_engine_results_equal_direct_calls(council, all_members, pipeline):
    _, _, tr, gens, x_u8, _, _ = council
    params = gens if all_members else gens[0]
    engine = BatchingEngine(tr, params, image_hw=(HW, HW), max_batch=4,
                            max_delay_ms=100.0, all_members=all_members,
                            pipeline=pipeline)
    engine.start()
    try:
        futures = [engine.submit(x_u8[i % B], seed=7 + i) for i in range(6)]
        outs = [f.result(timeout=120) for f in futures]
        stats = engine.snapshot_stats()
    finally:
        engine.stop()
    assert stats["requests"] == 6
    for i, out in enumerate(outs):
        z = engine.make_z(7 + i)[None]
        if all_members:
            want = tr.translate_all_u8io_device(gens, x_u8[i % B][None],
                                                z)[:, 0].numpy()
        else:
            want = tr.translate_u8io(gens[0], x_u8[i % B][None], z=z)[0]
        assert out.shape == want.shape
        # fp32: the batch the engine coalesced vs a batch of one
        assert _levels(out, want) <= 1


def test_npz_from_jax_package_loads_strictly(council, tmp_path):
    jtr, stacked, tr, gens, x_u8, _, z = council
    path = str(tmp_path / "gen.npz")
    save_params_npz(path, stacked)
    loaded = tr.load_members(load_generator_state_dicts(path, tr.cfg))
    for m in range(N):
        np.testing.assert_array_equal(
            tr.translate_u8io(loaded, x_u8, z=z[m], member=m),
            tr.translate_u8io(gens, x_u8, z=z[m], member=m))


def test_pt_from_export_adain_gen_loads_strictly(council, tmp_path):
    _, stacked, tr, gens, x_u8, _, z = council
    g = tr.cfg.gen
    path = str(tmp_path / "gen.pt")
    torch.save({f"a2b_{i}": {k: torch.from_numpy(np.array(v)) for k, v in
                             export_adain_gen(p, g.n_downsample, g.n_res,
                                              g.mlp_n_blk, g.dim).items()}
                for i, p in enumerate(unstack_members(stacked))}, path)
    loaded = tr.load_members(load_generator_state_dicts(path, tr.cfg))
    assert len(loaded) == N
    for m in range(N):
        np.testing.assert_array_equal(
            tr.translate_u8io(loaded, x_u8, z=z[m], member=m),
            tr.translate_u8io(gens, x_u8, z=z[m], member=m))


def test_checkpoint_formats_not_ported_are_rejected(council, tmp_path):
    _, _, tr, _, _, _, _ = council
    with pytest.raises(ValueError, match="export"):
        load_generator_state_dicts(str(tmp_path / "step_00000004"), tr.cfg)
    # quant is ported; what the JAX Translator refuses, the port refuses:
    # the static mode without its calibrated stats
    with pytest.raises(ValueError, match="calibrated stats"):
        Translator(Config.from_dict({"quant": "w8a8_static"}))


@pytest.mark.parametrize("flag", [
    # --data_parallel and --member_parallel are ported
    # (tests/test_torch_parallel_serve.py); the JAX CLI's rules hold: the
    # buckets split evenly over the data axis, and member parallelism
    # serves the whole council
    ({"data_parallel": 3}, "0", "multiple of --data_parallel"),
    ({"member_parallel": 2}, "0", "requires --member all"),
    # --calibration is ported; the JAX CLI refuses it with --member all
    ({"calibration": "q.npz"}, "all", "cannot use --calibration")])
def test_build_engine_rejects_flags_not_ported(council, flag):
    kwargs, member, match = flag
    with pytest.raises(SystemExit, match=match):
        serve.build_engine(load_config(CONFIG), "unused.pt", member, "a2b",
                           4, 5.0, device="cpu", **kwargs)


def test_translator_defaults_to_the_card():
    tr = Translator(load_config(CONFIG))
    assert tr.device.type == "cuda"
    if not torch.cuda.is_available():
        # no card here: making the members raises instead of using the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            tr.init_members(1, seed=0)


def test_build_engine_without_a_device_does_not_serve_on_the_cpu(
        council, tmp_path):
    _, stacked, _, _, _, _, _ = council
    path = str(tmp_path / "gen.npz")
    save_params_npz(path, stacked)
    cfg = load_config(CONFIG)
    if torch.cuda.is_available():
        engine = serve.build_engine(cfg, path, "0", "a2b", 4, 5.0,
                                    warmup=False)
        try:
            assert engine.translator.device.type == "cuda"
        finally:
            engine.stop()
        return
    with pytest.raises((AssertionError, RuntimeError)):
        serve.build_engine(cfg, path, "0", "a2b", 4, 5.0, warmup=False)
    with pytest.raises((AssertionError, RuntimeError)):
        serve.main(["--config", CONFIG, "--checkpoint", path, "--no_warmup"])


def test_serve_cli_rejects_quant():
    # --quant is ported; as the JAX CLI does, it refuses the static mode
    # without --calibration, before it reads the checkpoint
    with pytest.raises(ValueError, match="calibrated stats"):
        serve.main(["--config", CONFIG, "--checkpoint", "x.pt",
                    "--quant", "w8a8_static"])


def test_http_server_translates(council, tmp_path):
    from PIL import Image

    _, stacked, tr, gens, x_u8, _, _ = council
    path = str(tmp_path / "gen.npz")
    save_params_npz(path, stacked)
    cfg = load_config(CONFIG)
    engine = serve.build_engine(cfg, path, "all", "a2b", 4, 5.0,
                                device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 serve.make_handler(engine, cfg))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(x_u8[0]).save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=60)
        conn.request("POST", "/translate?seed=3", body=buf.getvalue())
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        assert resp.getheader("X-Members") == str(N)
        assert Image.open(io.BytesIO(body)).size == (N * HW, HW)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["members"] == N and health["device"] == "cpu"
        conn.request("POST", "/translate", body=b"",
                     headers={"Content-Length": str(serve.MAX_BODY_BYTES + 1)})
        assert conn.getresponse().status == 413
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_sigmoid_mask_translate_matches_jax():
    """mask_activation="sigmoid": the decoder leaves the mask channel raw
    and the compositing squashes it (the other reading of the mask)."""
    raw = {"compute_dtype": "float32",
           "council": {"council_size": 1, "mask_activation": "sigmoid"},
           "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3,
                   "n_downsample": 2, "n_res": 1},
           "crop_image_height": 16, "crop_image_width": 16}
    from councilx.config import Config as JConfig

    jtr = JTranslator(JConfig.from_dict(raw))
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    z = np.random.default_rng(6).standard_normal((2, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(jtr.gen.init)(jax.random.PRNGKey(2),
                                                  jnp.asarray(x))["params"])
    jimg, jmask = jtr.translate(params, jnp.asarray(x), z=jnp.asarray(z))
    cfg = Config.from_dict(raw)
    tr = Translator(cfg, device="cpu")
    gen = tr.load_members(params_to_state_dicts(params, cfg))[0]
    img, mask = tr.translate(gen, x, z=z)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), atol=1e-4)


def test_extract_member_state_dicts_layouts():
    from councilx_torch.ckpt.torch_convert import extract_member_state_dicts

    sd = {"enc_content.model.0.conv.weight": 1}
    assert extract_member_state_dicts(sd, "a2b") == [sd]
    assert extract_member_state_dicts({"a2b_1": 2, "a2b_0": 1},
                                      "a2b") == [1, 2]
    assert extract_member_state_dicts({"a": [1, 2]}, "a2b") == [1, 2]
    assert extract_member_state_dicts({"b2a": 3}, "b2a") == [3]
    assert extract_member_state_dicts({"0": 1, "1": 2}, "a2b") == [1, 2]
    assert extract_member_state_dicts([1, 2], "a2b") == [1, 2]
    with pytest.raises(ValueError):
        extract_member_state_dicts({"unrelated": 1}, "a2b")


@pytest.mark.parametrize("size", [(40, 30), (30, 52), (36, 36)])
def test_serve_preprocessing_matches_jax(size):
    from PIL import Image

    from councilx.data.dataset import resize_crop_image as jresize
    from councilx_torch.data.dataset import resize_crop_image

    arr = np.random.default_rng(3).integers(0, 256, size + (3,),
                                            dtype=np.uint8)
    img = Image.fromarray(arr)
    np.testing.assert_array_equal(resize_crop_image(img, 36, 32),
                                  jresize(img, 36, 32))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    np.testing.assert_array_equal(serve.preprocess_bytes(buf.getvalue(),
                                                         36, 32),
                                  jresize(img, 36, 32))


def test_init_members_is_seeded():
    cfg = load_config(CONFIG)
    tr = Translator(cfg, device="cpu")
    a, b = tr.init_members(2, seed=11), tr.init_members(2, seed=11)
    c = tr.init_members(1, seed=12)
    for k, v in a[1].state_dict().items():
        assert torch.equal(v, b[1].state_dict()[k]), k
    w = a[0].state_dict()["enc_content.model.3.model.0.model.0.conv.weight"]
    assert not torch.equal(w, a[1].state_dict()[
        "enc_content.model.3.model.0.model.0.conv.weight"])
    assert not torch.equal(w, c[0].state_dict()[
        "enc_content.model.3.model.0.model.0.conv.weight"])
    # kaiming (he_normal): std sqrt(2 / fan_in), fan_in = 32 * 3 * 3
    assert abs(w.std().item() / (2 / 288) ** 0.5 - 1) < 0.1
