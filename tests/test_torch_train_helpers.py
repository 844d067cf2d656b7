"""Helpers for the train-step parity tests (tests/test_torch_train*.py);
this file holds no tests of its own.

One JAX ``CouncilTrainer`` and one port ``CouncilTrainer`` on the same
config, the same weights (the JAX init, carried into the port through
``councilx_torch.ckpt.manager.train_params_to_state_dicts``), the same numpy
batch and the z codes the JAX step draws, derived exactly as ``_step``
derives them and injected into the port's ``train_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from councilx.config import Config as JConfig
from councilx.train.trainer import CouncilTrainer as JTrainer
from councilx.train.trainer import TrainState as JTrainState
from councilx.train.trainer import draw_phase_zs as jdraw_phase_zs
from councilx_torch.ckpt.manager import train_params_to_state_dicts
from councilx_torch.config import Config
from councilx_torch.train.trainer import CouncilTrainer

# tests/test_train_step.py::tiny_config, in parity mode (f32, two-pass
# statistics, the reference engines)
TINY = {
    "batch_size": 2, "lr": 1e-4, "weight_decay": 1e-4, "gan_w": 1.0,
    "recon_x_w": 10.0, "recon_s_w": 1.0, "recon_c_w": 1.0,
    "compute_dtype": "float32", "parity_mode": True,
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
            "n_res": 2},
    "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
    "council": {"council_size": 2, "council_w": 0.2},
    "data": {"crop_image_height": 32, "crop_image_width": 32},
}
LR = TINY["lr"]


def raw_config(**over):
    raw = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in TINY.items()}
    for k, v in over.items():
        raw[k] = ({**raw[k], **v} if isinstance(raw.get(k), dict)
                  and isinstance(v, dict) else v)
    return raw


def batch(seed=0, b=2, hw=32):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
            r.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32))


class Pair:
    """The two trainers on one config, and the JAX init as numpy."""

    def __init__(self, **over):
        raw = raw_config(**over)
        self.jcfg, self.cfg = JConfig.from_dict(raw), Config.from_dict(raw)
        self.jt = JTrainer(self.jcfg)
        self.pt = CouncilTrainer(self.cfg, device="cpu")
        state = jax.jit(self.jt.init_state)(jax.random.PRNGKey(0))
        self.params = jax.device_get(state.params)
        self.rng = np.asarray(jax.device_get(state.rng))

    def jax_state(self):
        """A fresh JAX TrainState (step 0) from the numpy init."""
        params = jax.device_put(self.params)
        dirs = self.jt.directions
        return JTrainState(
            step=jnp.zeros((), jnp.int32), rng=jnp.asarray(self.rng),
            params=params,
            opt_gen=self.jt.gen_tx.init({d: params[d]["gen"] for d in dirs}),
            opt_dis=self.jt.dis_tx.init({d: params[d]["dis"] for d in dirs}),
            opt_cdis=self.jt.cdis_tx.init({d: params[d]["cdis"]
                                           for d in dirs}))

    def port_state(self):
        return self.pt.load_state(train_params_to_state_dicts(self.params,
                                                              self.cfg))

    def jax_zs(self, state):
        """The z codes ``_step`` draws from ``state``, as numpy, in the
        port's ``zs`` layout."""
        jt, cfg = self.jt, self.jcfg
        n, sd = jt.n, cfg.gen.style_dim
        b = TINY["batch_size"]
        _, k_z = jax.random.split(state.rng)

        def draw(fold):
            return np.array(jax.random.normal(
                jax.random.fold_in(k_z, fold), (n, b, sd), jt.dtype))

        zs_gen, zs_cdis, zs_dis = jdraw_phase_zs(draw, jt.directions,
                                                 cfg.z_mode)
        zs = {"gen": zs_gen, "cdis": zs_cdis, "dis": zs_dis}
        ratio = max(1, cfg.council.council_dis_relative_iteration)
        if ratio > 1 and cfg.council.cdis_ratio_mode == "k_per_step":
            zs["cdis_repeat"] = [
                {d: np.array(jax.random.normal(
                    jax.random.fold_in(k_z, 1000 + it * 8 + di),
                    (n, b, sd), jt.dtype))
                 for di, d in enumerate(jt.directions)}
                for it in range(1, ratio)]
        return zs

    def run(self, steps=2, seed=0):
        """``steps`` train steps on both sides from the same state ->
        (JAX metrics per step, port metrics per step, JAX params as port
        state dicts, the port's state)."""
        x_a, x_b = batch(seed)
        js, ps = self.jax_state(), self.port_state()
        jm, pm = [], []
        for _ in range(steps):
            zs = self.jax_zs(js)
            js, m = self.jt.train_step(js, jnp.asarray(x_a),
                                       jnp.asarray(x_b))
            jm.append({k: float(v) for k, v in jax.device_get(m).items()})
            ps, m = self.pt.train_step(ps, x_a, x_b, zs=zs)
            pm.append({k: float(v) for k, v in m.items()})
        want = train_params_to_state_dicts(jax.device_get(js.params),
                                           self.cfg)
        return jm, pm, want, ps


def assert_metrics_close(jm, pm, rtol):
    for step, (a, b) in enumerate(zip(jm, pm)):
        assert set(a) == set(b), (step, sorted(set(a) ^ set(b)))
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")


def norm_removed(name):
    """A generator conv bias that IN/AdaIN follows: its gradient is zero in
    exact arithmetic (the norm subtracts it again), so what autograd
    computes for it is rounding noise."""
    return name.endswith("conv.bias") and name.startswith(
        ("enc_content.", "dec.model.0."))


def max_param_diff(want, state):
    """Largest |port - JAX| over every parameter of every member and group,
    as state dicts."""
    got = state.state_dicts()
    return max(float((a[k] - b[k]).abs().max())
               for d, groups in want.items()
               for grp, sds in groups.items()
               for a, b in zip(sds, got[d][grp])
               for k in a)


def named_grads(modules, loss):
    """d loss / d every parameter of ``modules`` -> one {name: grad} per
    module."""
    params = [list(m.named_parameters()) for m in modules]
    flat = [p for ps in params for _, p in ps]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    out = []
    for ps in params:
        out.append({})
        for name, p in ps:
            g = next(grads)
            out[-1][name] = torch.zeros_like(p) if g is None else g
    return out


def assert_grads_close(got, want, rel):
    """Each tensor within ``rel`` of its largest |JAX| value; the
    norm-removed biases, whose gradients are rounding noise, within ``rel``
    of the member's largest gradient."""
    for i, (g, w) in enumerate(zip(got, want)):
        top = max(float(t.abs().max()) for t in w.values())
        for name, t in g.items():
            ref = w[name]
            scale = top if norm_removed(name) else float(ref.abs().max())
            tol = max(rel * scale, 1e-12)
            err = float((t - ref).abs().max())
            assert err <= tol, (i, name, err, tol)

