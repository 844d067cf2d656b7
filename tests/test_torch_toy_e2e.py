"""The port's toy end-to-end run (``councilx_torch/tools/toy_e2e.py``) on
the CPU: its synthetic two-domain data bit-equal to ``tools/toy_e2e.py``'s,
its verdict on fixed arrays, and a 2-step plumbing run (and 1 + resumed 1)
through the port's train loop. The 600-step run that gives the verdict
needs the card.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from councilx_torch.tools import toy_e2e

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import toy_e2e as jtoy  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("size", [64, 32])
def test_make_dataset_is_bit_equal_to_the_jax_tools(tmp_path, size):
    toy_e2e.make_dataset(str(tmp_path / "port"), n_train=3, n_test=2,
                         size=size, seed=5)
    jtoy.make_dataset(str(tmp_path / "jax"), n_train=3, n_test=2, size=size,
                      seed=5)
    for split, n in (("trainA", 3), ("trainB", 3), ("testA", 2),
                     ("testB", 2)):
        names = sorted(os.listdir(tmp_path / "port" / split))
        assert names == sorted(os.listdir(tmp_path / "jax" / split))
        assert len(names) == n
        for name in names:
            with Image.open(tmp_path / "port" / split / name) as a, \
                    Image.open(tmp_path / "jax" / split / name) as b:
                assert a.size == (size, size)
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _arrays(size=64, edit_in=0.5, edit_out=0.1, mask_in=0.9, mask_out=0.2):
    """Inputs, two members' translations that change the bar band by
    ``edit_in`` and the rest by ``edit_out``, and masks open ``mask_in``
    in the band and ``mask_out`` elsewhere."""
    x = np.zeros((3, size, size, 3), np.float32)
    r0, r1 = 26 * size // 64, 38 * size // 64
    m = 8 * size // 64
    delta = np.full((size, size), edit_out, np.float32)
    delta[r0:r1, m:-m] = edit_in
    x_t = np.broadcast_to(delta[None, None, :, :, None],
                          (2, 3, size, size, 3)).copy()
    mask = np.full((2, 3, size, size, 1), mask_out, np.float32)
    mask[:, :, r0:r1, m:-m] = mask_in
    return x, x_t, mask


def test_verdict_on_fixed_arrays():
    x, x_t, mask = _arrays()
    out, ok = toy_e2e.verdict(x, x_t, mask, 64, "a2b_")
    # outside the band means every row above and below it, all columns
    assert out == {"a2b_change_in_bar": 0.5, "a2b_change_outside": 0.1,
                   "a2b_edit_locality": 5.0, "a2b_mask_in_bar": 0.9,
                   "a2b_mask_outside": 0.2, "a2b_mask_locality": 4.5}
    assert ok is True
    # no mask: only the edit counts
    out, ok = toy_e2e.verdict(x, x_t, None, 64, "b2a_")
    assert sorted(out) == ["b2a_change_in_bar", "b2a_change_outside",
                           "b2a_edit_locality"] and ok


@pytest.mark.parametrize("over", [
    {"edit_in": 0.19, "edit_out": 0.1},     # in-band change not > 2x
    {"mask_in": 0.2, "mask_out": 0.2},      # the mask does not focus
])
def test_verdict_fails_what_does_not_remove_the_bar(over):
    x, x_t, mask = _arrays(size=32, **over)
    assert toy_e2e.verdict(x, x_t, mask, 32, "a2b_")[1] is False


@pytest.mark.parametrize("extra", [[], ["--resume_mid"]])
def test_two_step_run_on_the_cpu(tmp_path, capsys, extra):
    out = toy_e2e.main(["--steps", "2", "--size", "32", "--batch", "2",
                        "--out", str(tmp_path), "--device", "cpu"] + extra)
    assert out["steps"] == 2 and out["resume_mid"] == bool(extra)
    assert isinstance(out["pass"], bool)
    for k in ("a2b_change_in_bar", "a2b_change_outside", "a2b_mask_in_bar",
              "a2b_mask_outside"):
        assert np.isfinite(out[k]), k
    assert os.path.exists(tmp_path / "toy_samples_a2b.jpg")
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"metric": "toy_glasses_removal_e2e"')


def test_toy_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        toy_e2e.main(["--steps", "2", "--size", "32", "--batch", "2",
                      "--out", str(tmp_path)])
