"""The port's data path (councilx_torch/data) against the JAX package's.

The loaders are numpy on both sides and must give the same uint8 batches
bit for bit: shuffled image folders (the C++ decode and the PIL pool), a
resume fast-forward, ``head_rows``, a file-list source and the synthetic
source. The augment is held bitwise in f32 with each row's crop and flip
derived exactly as ``councilx/data/ondevice.py`` derives them from
``jax.random`` and injected into the port's. JPEG fixtures are written
from a numpy seed.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from councilx.config import Config as JConfig
from councilx.data import loader as jloader
from councilx.data.dataset import ImageFolderDataset as JFolder
from councilx.data.ondevice import augment_batch as jaugment
from councilx.data.ondevice import normalize_batch as jnormalize
from councilx.data.ondevice import resize_bilinear as jresize
from councilx_torch.config import Config
from councilx_torch.data import loader, ondevice
from councilx_torch.data.dataset import (ImageFolderDataset, is_image_file,
                                         list_images)

NEW_SIZE = 36
SPLITS = ("trainA", "trainB", "testA", "testB")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """trainA/B with 11 and 9 JPEGs of assorted sizes (portrait, landscape,
    square, one already at new_size), testA/B with 5 and 3; one PNG."""
    root = tmp_path_factory.mktemp("data")
    r = np.random.default_rng(0)
    counts = {"trainA": 11, "trainB": 9, "testA": 5, "testB": 3}
    for split, n in counts.items():
        os.makedirs(root / split)
        for i in range(n):
            h, w = [(44, 40), (38, 52), (36, 36), (60, 41)][i % 4]
            arr = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = "png" if (split, i) == ("trainA", 3) else "jpg"
            Image.fromarray(arr).save(root / split / f"{i:03d}.{ext}")
    (root / "trainA" / "notes.txt").write_text("not an image")
    return root


def _configs(data_root, **extra):
    raw = {"batch_size": 3, "new_size": NEW_SIZE, "crop_image_height": 32,
           "crop_image_width": 32, "num_workers": 2,
           "data_root": str(data_root), **extra}
    return JConfig.from_dict(raw), Config.from_dict(raw)


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_listing_matches(data_root):
    from councilx.data.dataset import list_images as jlist
    for split in SPLITS:
        assert list_images(str(data_root / split)) == jlist(
            str(data_root / split))
    assert is_image_file("a.JPEG") and not is_image_file("a.txt")


@pytest.mark.parametrize("decode", ["native", "pil"])
@pytest.mark.parametrize("start_batch", [0, 3])
def test_folder_loaders_match_the_jax_loaders(data_root, decode,
                                              start_batch):
    """Shuffled train streams over more than one epoch (11 and 9 images,
    batch 3), resumed at batch 3 or not, and the single-epoch test splits
    with their ragged last batch."""
    jcfg, cfg = _configs(data_root)
    jl = jloader.get_all_data_loaders(jcfg, start_batch=start_batch)
    pl = loader.get_all_data_loaders(cfg, start_batch=start_batch)
    for j, p in zip(jl, pl):
        if decode == "pil":
            j._native = p._native = None
        assert p.native == (decode == "native" and j._native is not None)
    for j, p in zip(jl[:2], pl[:2]):
        want, got = _take(iter(j), 8), _take(iter(p), 8)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    for j, p in zip(jl[2:], pl[2:]):
        want, got = list(j), list(p)
        assert [a.shape for a in got] == [a.shape for a in want]
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_native_decode_is_used_for_image_folders(data_root):
    """Where g++, libjpeg and libpng are present the loader decodes
    natively, as the JAX loader does, and says so."""
    _, cfg = _configs(data_root)
    train_a = loader.get_all_data_loaders(cfg)[0]
    jcfg, _ = _configs(data_root)
    assert train_a.native == (jloader.get_all_data_loaders(jcfg)[0]._native
                              is not None)


def test_resume_fast_forward_continues_the_stream(data_root):
    """start_batch = 3 gives the stream from its fourth batch on."""
    _, cfg = _configs(data_root)
    full = _take(iter(loader.get_all_data_loaders(cfg)[0]), 7)
    resumed = _take(iter(loader.get_all_data_loaders(
        cfg, start_batch=3)[0]), 4)
    for a, b in zip(full[3:], resumed):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 3, 7])
def test_head_rows_match(data_root, n):
    jcfg, cfg = _configs(data_root)
    for j, p in zip(jloader.get_all_data_loaders(jcfg, start_batch=5),
                    loader.get_all_data_loaders(cfg, start_batch=5)):
        np.testing.assert_array_equal(p.head_rows(n), j.head_rows(n))


def test_filelist_source_matches(data_root, tmp_path):
    lists = {}
    for split, key in (("trainA", "data_list_train_a"),
                       ("trainB", "data_list_train_b"),
                       ("testA", "data_list_test_a"),
                       ("testB", "data_list_test_b")):
        names = sorted(os.listdir(data_root / split))[::-1]
        path = tmp_path / f"{split}.txt"
        path.write_text("".join(f"{split}/{n} 0\n" for n in names
                                if n.endswith((".jpg", ".png"))))
        lists[key] = str(path)
    jcfg, cfg = _configs(data_root, **lists)
    jl, pl = (jloader.get_all_data_loaders(jcfg),
              loader.get_all_data_loaders(cfg))
    assert not any(p.native for p in pl)
    for j, p in zip(jl[:2], pl[:2]):
        for a, b in zip(_take(iter(j), 5), _take(iter(p), 5)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pl[2].head_rows(4), jl[2].head_rows(4))


def test_synthetic_source_matches():
    raw = {"batch_size": 4, "new_size": 20, "crop_image_height": 16,
           "crop_image_width": 16}
    jl = jloader.get_all_data_loaders(JConfig.from_dict(raw), synthetic=True,
                                      synthetic_size=10)
    pl = loader.get_all_data_loaders(Config.from_dict(raw), synthetic=True,
                                     synthetic_size=10)
    for j, p in zip(jl, pl):
        assert p.seed == j.seed
        for a, b in zip(_take(iter(j), 3) if j.infinite else list(j),
                        _take(iter(p), 3) if p.infinite else list(p)):
            np.testing.assert_array_equal(a, b)
    assert pl[0].seed == zlib.crc32(b"trainA") % 2 ** 31


def test_sharded_loaders_match(data_root):
    """Two shards of one global batch: each shard's rows equal the JAX
    loader's for that shard."""
    ds, jds = (ImageFolderDataset(str(data_root / "trainA"), NEW_SIZE),
               JFolder(str(data_root / "trainA"), NEW_SIZE))
    for shard in range(2):
        p = loader.DataLoader(ds, 2, seed=5, shard_index=shard,
                              shard_count=2, num_workers=2)
        j = jloader.DataLoader(jds, 2, seed=5, shard_index=shard,
                               shard_count=2, num_workers=2)
        for a, b in zip(_take(iter(j), 4), _take(iter(p), 4)):
            np.testing.assert_array_equal(a, b)


def test_loader_errors_reach_the_consumer(tmp_path):
    folder = tmp_path / "bad"
    folder.mkdir()
    for i in range(2):
        (folder / f"{i}.jpg").write_bytes(b"not a jpeg")
    ds = ImageFolderDataset(str(folder), 16)
    with pytest.raises(Exception):
        next(iter(loader.DataLoader(ds, 2, num_workers=1)))


# ---------------------------------------------------------------------------
# the augment
# ---------------------------------------------------------------------------


def _jax_crops(rng, b, h, w, crop_h, crop_w, row_offset):
    """Each row's (oy, ox, flip), derived exactly as
    councilx/data/ondevice.py::augment_batch derives them."""
    out = []
    for i in range(b):
        k_y, k_x, k_flip = jax.random.split(
            jax.random.fold_in(rng, row_offset + i), 3)
        out.append((int(jax.random.randint(k_y, (), 0, h - crop_h + 1)),
                    int(jax.random.randint(k_x, (), 0, w - crop_w + 1)),
                    int(jax.random.bernoulli(k_flip))))
    return torch.tensor(np.array(out, dtype=np.int64).T)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape,crop,row_offset", [
    ((4, 36, 36, 3), (32, 32), 0), ((3, 40, 52, 3), (32, 48), 6),
    ((2, 20, 20, 3), (20, 20), 0), ((5, 33, 29, 3), (17, 11), 2)])
def test_augment_matches_jax_bitwise(seed, shape, crop, row_offset):
    r = np.random.default_rng(seed)
    x = r.integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaugment(key, jnp.asarray(x), *crop, train=True,
                               row_offset=row_offset))
    crops = _jax_crops(key, shape[0], shape[1], shape[2], *crop, row_offset)
    got = ondevice.augment_batch(torch.from_numpy(x), *crop, crops=crops)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,crop", [((4, 36, 36, 3), (32, 32)),
                                        ((3, 41, 52, 3), (32, 48))])
def test_center_crop_and_normalize_match_jax_bitwise(shape, crop):
    x = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jaugment(jax.random.PRNGKey(0), jnp.asarray(x), *crop,
                               train=False))
    got = ondevice.augment_batch(torch.from_numpy(x), *crop, train=False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ondevice.normalize_batch(torch.from_numpy(x)).numpy(),
        np.asarray(jnormalize(jnp.asarray(x))))
    assert ondevice.normalize_batch(torch.from_numpy(x),
                                    torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("out", [(8, 11), (34, 40), (17, 30)])
def test_resize_bilinear_matches_jax(out):
    """Shrinking (antialiased) and growing: f32 sums of a few taps in
    another order."""
    x = np.random.default_rng(4).standard_normal((2, 17, 23, 3)).astype(
        np.float32)
    want = np.asarray(jresize(jnp.asarray(x), *out))
    got = ondevice.resize_bilinear(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_draw_crops_are_keyed_by_step_stream_and_global_row():
    a = ondevice.draw_crops(0, 5, 0, range(8), 270, 270, 256, 256)
    assert a.shape == (3, 8) and a.dtype == torch.int64
    assert int(a[:2].min()) >= 0 and int(a[:2].max()) <= 14
    assert set(a[2].tolist()) <= {0, 1}
    # the same key, the same draw; rows 4..7 of one process are rows 0..3
    # of another with row_offset 4
    assert torch.equal(a, ondevice.draw_crops(0, 5, 0, range(8), 270, 270,
                                              256, 256))
    assert torch.equal(a[:, 4:], ondevice.draw_crops(0, 5, 0, range(4, 8),
                                                     270, 270, 256, 256))
    for other in ((1, 5, 0), (0, 6, 0), (0, 5, 1)):
        assert not torch.equal(a, ondevice.draw_crops(
            *other, range(8), 270, 270, 256, 256))
    # many draws cover the offsets and both flips
    many = ondevice.draw_crops(0, 0, 0, range(400), 40, 40, 32, 32)
    assert set(many[0].tolist()) == set(range(9))
    assert 150 < int(many[2].sum()) < 250


def test_augment_refuses_train_without_crops():
    with pytest.raises(ValueError, match="needs crops"):
        ondevice.augment_batch(torch.zeros(2, 8, 8, 3, dtype=torch.uint8),
                               4, 4)
