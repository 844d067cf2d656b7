"""councilx_torch's AdaINGen vs the JAX package's, on the same weights.

The JAX generator is initialised from a seed; its parameter tree goes
through the port's converter into the port's AdaINGen (strict load); the
same numpy images and style codes go through both. fp32 on the CPU.

* dim 8, n_res 2, 32px against JAX in ``parity_mode`` (f32, two-pass
  statistics, reference boundary and upsample ops);
* dim 32 (content dim 128, so JAX's ``conv3x3_eligible`` passes) against
  JAX with ``use_pallas`` and ``use_pallas_norm``, its Pallas kernels run
  in interpret mode;
* dim 8 under the conv engines, outside parity mode (f32, ``norm_stats:
  two_pass``, the IN statistics the port's IN sites take): the JAX
  defaults (phase_fused 7x7 convs, the dilated upsample), ``upsample_engine:
  phase`` and ``ln_fused``, and the defaults with ``resblock_fuse_pad``
  (the strips engine at the resblocks, on K1's pad-1 op in the port).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from councilx.config import Config as JConfig
from councilx.inference.translate import Translator as JTranslator
from councilx.nn.generator import AdaINGen as JAdaINGen
from councilx_torch.ckpt.manager import params_to_state_dicts
from councilx_torch.config import Config
from councilx_torch.inference.translate import Translator

torch.set_num_threads(2)


def _raw(dim, **over):
    raw = {"compute_dtype": "float32",
           "council": {"council_size": 1},
           "gen": {"dim": dim, "mlp_dim": 16, "style_dim": 3,
                   "n_downsample": 2, "n_res": 2},
           "crop_image_height": 32, "crop_image_width": 32}
    raw.update(over)
    return raw


ENGINES = {
    "defaults_dim8": {},
    "phase_dim8": {"upsample_engine": "phase"},
    "ln_fused_dim8": {"upsample_engine": "ln_fused"},
    "resblock_fuse_pad_dim8": {"resblock_fuse_pad": True},
}
CASES = {
    "parity_dim8": (_raw(8, parity_mode=True), contextlib.nullcontext),
    "pallas_dim32": (_raw(32, use_pallas=True, use_pallas_norm=True),
                     pltpu.force_tpu_interpret_mode),
    **{name: (_raw(8, norm_stats="two_pass", **over),
              contextlib.nullcontext) for name, over in ENGINES.items()},
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(JAX outputs, port generator, x, z) for one case. The JAX outputs:
    content, style, and the decode of that content with z."""
    raw, ctx = CASES[request.param]
    jcfg, cfg = JConfig.from_dict(raw), Config.from_dict(raw)
    jgen = JTranslator(jcfg).gen
    r = np.random.default_rng(0)
    x = r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = r.standard_normal((2, 3)).astype(np.float32)
    # the kernel flags leave the parameter tree unchanged, so initialise
    # through the plain XLA path (no interpret-mode forward)
    plain = JTranslator(JConfig.from_dict(
        {**raw, "use_pallas": False, "use_pallas_norm": False})).gen
    params = jax.device_get(jax.jit(plain.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])

    def run(method, *args):
        return jax.jit(lambda v, *a: jgen.apply(v, *a, method=method))(
            {"params": params}, *args)

    with ctx():
        content = run(JAdaINGen.encode_content, jnp.asarray(x))
        want = {
            "content": np.asarray(content),
            "style": np.asarray(run(JAdaINGen.encode_style, jnp.asarray(x))),
            "decoded": np.asarray(run(JAdaINGen.decode, content,
                                      jnp.asarray(z))),
        }
    tgen = Translator(cfg, device="cpu").load_members(params_to_state_dicts(params, cfg))[0]
    return want, tgen, x, z


def test_encode_content(pair):
    want, tgen, x, _ = pair
    with torch.inference_mode():
        got = tgen.encode_content(torch.from_numpy(x)).numpy()
    assert got.shape == want["content"].shape
    # fp32 through 7 conv + IN layers (content is instance-normalized)
    np.testing.assert_allclose(got, want["content"], atol=1e-4, rtol=1e-4)


def test_encode_style(pair):
    want, tgen, x, _ = pair
    with torch.inference_mode():
        got = tgen.encode_style(torch.from_numpy(x)).numpy()
    assert got.shape == want["style"].shape == (2, 3)
    np.testing.assert_allclose(got, want["style"], atol=1e-4, rtol=1e-4)


def test_decode(pair):
    want, tgen, x, z = pair
    with torch.inference_mode():
        got = tgen.decode(torch.from_numpy(want["content"].copy()),
                          torch.from_numpy(z)).numpy()
    assert got.shape == want["decoded"].shape == (2, 32, 32, 4)
    # fp32 through the AdaIN resblocks, two upsample+LN stages and the
    # tanh output conv
    np.testing.assert_allclose(got, want["decoded"], atol=1e-4, rtol=1e-4)


def _route(gen):
    """The engines a port AdaINGen's blocks take: (fused upsample blocks,
    boundary engines of the fuse_pad blocks, resblock convs with fuse_pad),
    or "plain" where a 7x7 block folds no pad."""
    from councilx_torch.nn.blocks import Conv2dBlock
    blocks = [m for m in gen.modules() if isinstance(m, Conv2dBlock)]
    return (sum(m.fused_upsample for m in blocks),
            sorted({m.boundary_engine if m.fuse_pad else "plain"
                    for m in blocks if m.kernel_size == 7}),
            sum(m.fuse_pad for m in blocks if m.kernel_size == 3))


@pytest.mark.parametrize("parity", (False, True))
def test_parity_mode_takes_the_reference_route(parity):
    """Under ``parity_mode`` both packages' Translator and CouncilTrainer
    build the generator on the reference route (no fused upsample, the
    reference boundary engine, no resblock_fuse_pad), whatever the engine
    keys say; outside it they take the keys."""
    from councilx.train.trainer import CouncilTrainer as JTrainer
    from councilx_torch.train.trainer import CouncilTrainer

    raw = _raw(8, parity_mode=parity, upsample_engine="ln_fused",
               boundary_engine="phase", resblock_fuse_pad=True)
    jcfg, cfg = JConfig.from_dict(raw), Config.from_dict(raw)
    for jgen in (JTranslator(jcfg).gen, JTrainer(jcfg).gen):
        assert (jgen.fuse_upsample, jgen.boundary_engine,
                jgen.resblock_fuse_pad) == (
            (False, "reference", False) if parity
            else (True, "phase", True))
    want = ((0, ["reference"], 0) if parity else (2, ["phase"], 8))
    for gen in (Translator(cfg, device="cpu").make_gen(),
                CouncilTrainer(cfg, device="cpu").make_gen()):
        assert _route(gen) == want
