"""Periodic in-training FID.

Counterpart of ``councilx/eval/hook.py``. ``cfg.eval_iter > 0`` translates
a fixed set of test images every ``eval_iter`` steps and scores them
against the target domain's test images with InceptionV3-pool3 features
(pytorch-fid input convention: 299px PIL-bilinear, Fréchet in float64),
logged as ``fid_<direction>`` beside the loss curves. ``cfg.eval_member``
picks the member scored: an index (default 0), or ``"all"`` for the
paper's best-member protocol — every member's ``fid_<direction>_m<k>`` is
logged and ``fid_<direction>`` is their minimum (the translate is one call
of every member either way; "all" only multiplies the Inception passes).

Protocol note: both sides are the data loader's ``new_size`` views — full
frames, translated at ``new_size`` (the generator is fully convolutional).
The series is comparable across steps; ``councilx_torch.cli.eval`` reads
the original files for the target side instead, so compare in-training
numbers with offline or paper numbers only where ``new_size`` is the
original resolution — the hook warns once at construction when it can see
that they differ.

The style codes are drawn once, from their own ``torch.Generator`` seeded
with 7 (the JAX hook's fixed ``PRNGKey(7)``), and passed to
``CouncilTrainer.sample``: the training z stream (``state.generator``) is
not touched, so a resumed run with the hook on stays bit for bit the
uninterrupted one.

Multi-GPU: every rank calls the hook, since the translate is a collective
under member parallelism; the features and the FID are rank 0's
(``primary``), and the other ranks get ``{}``.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch

from councilx_torch.config import Config
from councilx_torch.data.ondevice import normalize_batch
from councilx_torch.eval.features import (extract_features,
                                          u8_to_inception_inputs)
from councilx_torch.eval.inception import MissingWeights, make_inception
from councilx_torch.eval.metrics import fid_from_features
from councilx_torch.inference.translate import _u8_from_unit

# the fixed style draw's seed (councilx/eval/hook.py: PRNGKey(7))
Z_SEED = 7


class TrainEvalHook:
    """Fixed eval inputs, style codes and target features; call at the eval
    cadence.

    Built once after the data loaders: takes up to ``cfg.eval_max_images``
    epoch-0 rows from each test loader via ``DataLoader.head_rows`` (no
    producer thread, unaffected by the resume fast-forward) and computes
    the target domain's Inception features. Each call translates with
    every member at the current parameters through ``trainer.sample`` and
    returns ``{"fid_<dir>": value, ...}``."""

    def __init__(self, cfg: Config, trainer, test_a, test_b):
        self.cfg = cfg
        self.directions = trainer.directions
        self.member = cfg.eval_member  # index | "all" (validated in config)
        try:
            self.model = make_inception(cfg.eval_inception_weights,
                                        trainer.device)
        except MissingWeights as e:
            raise MissingWeights(f"eval_iter > 0 needs eval_inception_"
                                 f"weights: {e}") from None
        self._warn_if_resized(test_a, test_b)

        raw = {"a": test_a.head_rows(cfg.eval_max_images),
               "b": test_b.head_rows(cfg.eval_max_images)}
        src = {"a2b": "a", "b2a": "b"}
        tgt = {"a2b": "b", "b2a": "a"}
        # full new_size frames, normalized — see the protocol note above
        self._inputs = {
            d: normalize_batch(torch.from_numpy(raw[src[d]])).to(
                trainer.device) for d in self.directions}
        self._z = {
            d: torch.randn((trainer.n, raw[src[d]].shape[0],
                            cfg.gen.style_dim),
                           generator=torch.Generator().manual_seed(Z_SEED))
            for d in self.directions}
        # a2b is scored against domain B's test images
        self._target_feats = {
            d: extract_features(self.model,
                                [u8_to_inception_inputs(raw[tgt[d]])])
            for d in self.directions}

    def _warn_if_resized(self, test_a, test_b) -> None:
        """Warn once when the loaders' new_size differs from the source
        files' native resolution — the in-training FID series is then NOT
        comparable to offline/paper numbers (see the protocol note)."""
        from PIL import Image

        for loader in (test_a, test_b):
            paths = getattr(loader.dataset, "paths", None)
            if not paths:
                continue  # synthetic data: nothing to compare
            try:
                with Image.open(paths[0]) as img:
                    native = min(img.size)
            except OSError:
                continue
            if native != self.cfg.data.new_size:
                warnings.warn(
                    f"in-training FID runs at new_size="
                    f"{self.cfg.data.new_size} but {paths[0]} is natively "
                    f"{native}px on its shorter side — the fid_* series is "
                    "self-consistent across steps but NOT comparable to "
                    "offline/paper FID; evaluate checkpoints with "
                    "councilx-torch-eval for comparable numbers",
                    stacklevel=3)
                return

    def features(self, trainer, state, primary: bool = True
                 ) -> Dict[str, list]:
        """{direction: [(n, 2048) features of each member scored]}: the
        fixed inputs translated by every member at the current parameters,
        through the Inception module; ``{}`` where not ``primary``, after
        the translate."""
        out = {}
        for d in self.directions:
            x_t, _ = trainer.sample(state, self._inputs[d], direction=d,
                                    z=self._z[d])
            if not primary:
                continue
            u8 = _u8_from_unit(x_t.float()).cpu().numpy()
            members = (range(u8.shape[0]) if self.member == "all"
                       else [self.member])
            out[d] = [extract_features(self.model,
                                       [u8_to_inception_inputs(u8[m])])
                      for m in members]
        return out

    def __call__(self, trainer, state, primary: bool = True
                 ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for d, feats in self.features(trainer, state, primary).items():
            fids = [fid_from_features(f, self._target_feats[d])
                    for f in feats]
            if self.member == "all":
                for m, v in enumerate(fids):
                    out[f"fid_{d}_m{m}"] = v
                # best-member protocol: the paper reports the member with
                # the lowest FID
                out[f"fid_{d}"] = min(fids)
            else:
                out[f"fid_{d}"] = fids[0]
        return out
