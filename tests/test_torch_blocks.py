"""councilx_torch.nn.blocks vs the flax blocks of councilx.nn.blocks.

Each flax module is initialised from a seed; its parameters go through the
port's converter (councilx_torch.ckpt.torch_export) into the port's module
with a strict load; the same numpy input goes through both. fp32 on the
CPU, where the port's kernel sites run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from councilx.nn.blocks import MLP as JMLP
from councilx.nn.blocks import Conv2dBlock as JConv2dBlock
from councilx.nn.blocks import MunitLayerNorm as JMunitLayerNorm
from councilx.nn.blocks import ResBlocks as JResBlocks
from councilx_torch.ckpt.torch_export import (_conv_block_inv,
                                              _res_blocks_inv, export_mlp)
from councilx_torch.nn.blocks import (MLP, Conv2dBlock, MunitLayerNorm,
                                      ResBlocks, pad2d, upsample_nearest_2x)

torch.set_num_threads(2)


def _load(module: torch.nn.Module, sd: dict, prefix: str) -> None:
    n = len(prefix) + 1
    module.load_state_dict({k[n:]: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)


def _adain_pairs(r, n, b, c):
    return [(r.standard_normal((b, c)).astype(np.float32),
             r.standard_normal((b, c)).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("norm,pad_type,k,s,p,act", [
    ("in", "reflect", 3, 1, 1, "relu"),
    ("ln", "reflect", 3, 1, 1, "relu"),
    ("adain", "reflect", 3, 1, 1, "relu"),
    ("none", "reflect", 3, 1, 1, "relu"),
    ("in", "zero", 3, 1, 1, "relu"),
    ("ln", "zero", 3, 1, 1, "relu"),
    ("adain", "zero", 3, 1, 1, "none"),
    ("none", "zero", 3, 1, 1, "tanh"),
    ("in", "reflect", 7, 1, 3, "relu"),
    ("in", "reflect", 4, 2, 1, "lrelu"),
    ("ln", "replicate", 5, 1, 2, "relu"),
])
def test_conv2dblock_matches_flax(norm, pad_type, k, s, p, act):
    r = np.random.default_rng(0)
    cin, cout = 8, 16
    x = r.standard_normal((2, 9, 8, cin)).astype(np.float32)
    jblk = JConv2dBlock(cout, k, s, p, norm=norm, activation=act,
                        pad_type=pad_type)
    args = ()
    targs = ()
    if norm == "adain":
        g, b = _adain_pairs(r, 1, 2, cout)[0]
        args = ((jnp.asarray(g), jnp.asarray(b)),)
        targs = ((torch.from_numpy(g), torch.from_numpy(b)),)
    params = jax.device_get(
        jblk.init(jax.random.PRNGKey(1), jnp.asarray(x), *args)["params"])
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x), *args))

    tblk = Conv2dBlock(cin, cout, k, s, p, norm=norm, activation=act,
                       pad_type=pad_type)
    _load(tblk, _conv_block_inv(params, "blk", norm=norm, adain_dim=cout),
          "blk")
    got = tblk(torch.from_numpy(x), *targs)
    # fp32: convolution and norm sums in another order
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
@pytest.mark.parametrize("precision", ["f32", "mixed", "bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_munit_layer_norm_matches_flax(precision, stats, dtype):
    r = np.random.default_rng(2)
    x = (r.standard_normal((2, 6, 5, 16)) * 2 + 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jln = JMunitLayerNorm(num_features=16, dtype=jdt, precision=precision,
                          stats=stats)
    xj = jnp.asarray(x, jdt)
    params = jax.device_get(jln.init(jax.random.PRNGKey(3), xj)["params"])
    want = np.asarray(jln.apply({"params": params}, xj), np.float32)
    tln = MunitLayerNorm(16, precision=precision, stats=stats)
    tln.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()}, strict=True)
    got = tln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        # all three precisions are the same f32 formula here
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                                   rtol=1e-5)
    else:
        # bf16 output (|y| < 4, where a bf16 step is at most 2**-6), and in
        # "bf16" mode statistics rounded to bf16 in each framework
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   atol=0.07, rtol=0.02)


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_resblocks_match_flax(norm):
    r = np.random.default_rng(4)
    dim, n_blocks = 16, 2
    x = r.standard_normal((2, 8, 8, dim)).astype(np.float32)
    jrb = JResBlocks(n_blocks, dim, norm=norm, activation="relu",
                     pad_type="reflect")
    pairs = _adain_pairs(r, 2 * n_blocks, 2, dim) if norm == "adain" else None
    jpairs = ([(jnp.asarray(g), jnp.asarray(b)) for g, b in pairs]
              if pairs else None)
    params = jax.device_get(
        jrb.init(jax.random.PRNGKey(5), jnp.asarray(x), jpairs)["params"])
    want = np.asarray(jrb.apply({"params": params}, jnp.asarray(x), jpairs))
    trb = ResBlocks(n_blocks, dim, norm=norm, activation="relu",
                    pad_type="reflect")
    _load(trb, _res_blocks_inv(params, "blk", n_blocks, norm=norm, dim=dim),
          "blk")
    tpairs = ([(torch.from_numpy(g), torch.from_numpy(b)) for g, b in pairs]
              if pairs else None)
    got = trb(torch.from_numpy(x), tpairs)
    # fp32 through four conv + norm layers
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5,
                               rtol=1e-5)


def test_mlp_matches_flax():
    r = np.random.default_rng(6)
    z = r.standard_normal((3, 8)).astype(np.float32)
    jmlp = JMLP(out_dim=40, dim=32, n_blk=3)
    params = jax.device_get(
        jmlp.init(jax.random.PRNGKey(7), jnp.asarray(z))["params"])
    want = np.asarray(jmlp.apply({"params": params}, jnp.asarray(z)))
    tmlp = MLP(8, 40, dim=32, n_blk=3)
    _load(tmlp, export_mlp(params, "mlp", 3), "mlp")
    got = tmlp(torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("pad_type", ["reflect", "replicate", "zero"])
def test_pad_and_upsample_match_jax(pad_type):
    from councilx.nn.blocks import pad2d as jpad2d
    from councilx.nn.blocks import upsample_nearest_2x as jup

    x = np.random.default_rng(8).standard_normal((2, 5, 4, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        pad2d(torch.from_numpy(x), 2, pad_type).numpy(),
        np.asarray(jpad2d(jnp.asarray(x), 2, pad_type)))
    np.testing.assert_array_equal(
        upsample_nearest_2x(torch.from_numpy(x)).numpy(),
        np.asarray(jup(jnp.asarray(x))))
