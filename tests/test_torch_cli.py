"""The port's translate and GUI CLIs against the JAX package's, on the CPU.

A JAX council-2 generator (gen dim 8, 32px, f32) is exported with
``councilx.ckpt.manager.save_params_npz``; both packages' folder-translate
CLIs read it. With ``--style_image`` (no random z) the outputs agree within
one uint8 level; with sampled z (different generators on the two sides)
the file names agree. The port's GUI answers a render with exactly what a
direct ``Translator`` call gives. The arrays are taken before the JPEG
encode.
"""

import http.client
import io
import json
import os
import threading
import urllib.parse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from councilx.ckpt.manager import save_params_npz
from councilx.cli import translate as jtranslate_cli
from councilx.config import load_config as jload_config
from councilx.inference.translate import Translator as JTranslator
from councilx_torch.cli import gui
from councilx_torch.cli import translate as translate_cli
from councilx_torch.config import load_config
from councilx_torch.data.dataset import _load_resize_crop
from councilx_torch.data.ondevice import normalize_batch
from councilx_torch.inference.translate import (Translator,
                                                denormalize_to_uint8)

TINY = {"batch_size": 2, "compute_dtype": "float32",
        "council": {"council_size": 2, "council_w": 0.2},
        "focus_loss": {"focus_enabled": True},
        "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
                "n_res": 1},
        "dis": {"dim": 8, "n_layer": 2, "num_scales": 1},
        "new_size": 36, "crop_image_height": 32, "crop_image_width": 32}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(TINY))
    folder = tmp / "in"
    folder.mkdir()
    r = np.random.default_rng(0)
    for i in range(5):      # 5 images, batch 2: a padded tail batch
        Image.fromarray(r.integers(0, 256, (40, 37 + i, 3), dtype=np.uint8)
                        ).save(folder / f"img{i}.jpg")
    style = tmp / "style.png"
    Image.fromarray(r.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
        style)
    jtr = JTranslator(jload_config(str(cfg_path)))
    stacked = jax.device_get(jax.jit(jax.vmap(jtr.gen.init,
                                              in_axes=(0, None)))(
        jax.random.split(jax.random.PRNGKey(0), 2),
        jnp.zeros((1, 32, 32, 3), jnp.float32))["params"])
    npz = str(tmp / "gen.npz")
    save_params_npz(npz, stacked)
    return tmp, str(cfg_path), str(folder), str(style), npz


@pytest.fixture
def saved(monkeypatch):
    """The arrays each CLI hands to PIL's save, by file name."""
    out = {}
    orig = Image.Image.save

    def save(self, fp, *a, **k):
        out[os.path.basename(str(fp))] = np.asarray(self).copy()
        return orig(self, fp, *a, **k)

    monkeypatch.setattr(Image.Image, "save", save)
    return out


def _run_both(monkeypatch, setup, saved, extra):
    tmp, cfg_path, folder, _, npz = setup
    common = ["--config", cfg_path, "--checkpoint", npz, "--input_folder",
              folder, "--batch_size", "2"] + extra
    monkeypatch.setattr("sys.argv", ["translate"] + common + [
        "--output_folder", str(tmp / "jax_out")])
    jtranslate_cli.main()
    want = dict(saved)
    saved.clear()
    assert translate_cli.main(common + ["--output_folder",
                                        str(tmp / "port_out"),
                                        "--device", "cpu"]) == 5
    return want, dict(saved)


def test_translate_style_image_matches_jax_cli(monkeypatch, setup, saved):
    style = setup[3]
    want, got = _run_both(monkeypatch, setup, saved,
                          ["--member", "all", "--style_image", style])
    assert sorted(got) == sorted(want) == sorted(
        f"img{i}_m{m}.jpg" for i in range(5) for m in range(2))
    for name in want:
        assert got[name].shape == want[name].shape == (32, 32, 3)
        # f32 on the CPU, sums in another order: a value may round to the
        # neighbouring uint8 level
        diff = np.abs(got[name].astype(np.int16) - want[name].astype(
            np.int16))
        assert diff.max() <= 1, name
    assert sorted(os.listdir(setup[0] / "port_out")) == sorted(want)


@pytest.mark.parametrize("extra", [["--member", "1"],
                                   ["--member", "all", "--num_style", "2"]])
def test_translate_z_mode_writes_the_jax_cli_names(monkeypatch, setup, saved,
                                                   extra):
    want, got = _run_both(monkeypatch, setup, saved, extra)
    assert sorted(got) == sorted(want)
    assert all(a.shape == (32, 32, 3) for a in got.values())


def test_translate_refuses_data_parallel(setup):
    """--data_parallel is ported (tests/test_torch_parallel_serve.py); as
    the JAX CLI does, it refuses a batch that does not split evenly, and
    more devices than the machine has."""
    _, cfg_path, folder, _, npz = setup
    common = ["--config", cfg_path, "--checkpoint", npz, "--input_folder",
              folder, "--output_folder", "unused"]
    with pytest.raises(SystemExit, match="not divisible"):
        translate_cli.main(common + ["--data_parallel", "2",
                                     "--batch_size", "3"])
    with pytest.raises(SystemExit, match="need 64 devices"):
        translate_cli.main(common + ["--data_parallel", "64",
                                     "--batch_size", "64"])


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_gui_renders_what_the_translator_gives(setup):
    _, cfg_path, folder, _, npz = setup
    cfg = load_config(cfg_path)
    srv = gui.make_server(cfg, npz, folder, port=0, device="cpu",
                          host="127.0.0.1")
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        status, body = _get(port, "/meta")
        meta = json.loads(body)
        assert status == 200 and meta["council_size"] == 2
        assert meta["images"] == [f"img{i}.jpg" for i in range(5)]
        assert _get(port, "/")[0] == 200

        tr = Translator(cfg, device="cpu")
        from councilx_torch.ckpt.manager import load_generator_state_dicts
        gens = tr.load_members(load_generator_state_dicts(npz, cfg))
        arr = _load_resize_crop(os.path.join(folder, "img2.jpg"), 36, 32)
        x = normalize_batch(torch.from_numpy(arr[None]))
        for member in ("1", "all"):
            status, body = _get(port, "/translate?" + urllib.parse.urlencode(
                {"image": "img2.jpg", "member": member, "seed": 7}))
            assert status == 200
            panels = json.loads(body)["panels"]
            rng = torch.Generator().manual_seed(7)
            if member == "all":
                out, mask = tr.translate_all_members(gens, x, rng=rng)
                outs = [out[i, 0] for i in range(2)]
            else:
                out, mask = tr.translate(gens, x, rng=rng, member=1)
                outs = [out[0]]
            titles = [p["title"] for p in panels]
            assert titles[0] == "input" and len(panels) == 1 + 2 * len(outs)
            for p, o in zip(panels[1:], outs):
                status, png = _get(port, p["url"])
                assert status == 200
                np.testing.assert_array_equal(
                    np.asarray(Image.open(io.BytesIO(png))),
                    denormalize_to_uint8(o.numpy()))
        assert _get(port, "/translate?image=..%2Fx.jpg")[0] == 404
        assert _get(port, "/translate?image=img0.jpg&member=9")[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
