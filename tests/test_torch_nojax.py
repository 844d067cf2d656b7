"""councilx_torch, chip_smoke.py and time_norm_forward.py import with JAX
and councilx blocked."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax")

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in BLOCKED or top.startswith(BLOCKED) or top == "councilx":
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import councilx_torch
    names = ["councilx_torch"] + [
        m.name for m in pkgutil.walk_packages(councilx_torch.__path__,
                                              "councilx_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    import time_norm_forward
    assert callable(chip_smoke.main) and callable(time_norm_forward.main)
    leaked = [m for m in sys.modules
              if m.split(".")[0] in BLOCKED or m.split(".")[0] == "councilx"]
    assert not leaked, leaked
    print(" ".join(names))
    print("imported", len(names), "modules")
""")


def test_port_imports_without_jax_or_councilx():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split()[-2])
    # every module of the package: config, schedules, ops (x4), nn (x4),
    # ckpt (x4), inference (x3), data (x2), cli (x2), losses (x4), train
    # (x3) and the package itself; since the eval slice also eval (x5),
    # cli/eval, cli/fid, cli/convert and tools (x2); since the quant slice
    # ops/quant, ops/upsample_conv and tools (x2 more)
    assert n >= 43, r.stdout
    for name in ("councilx_torch.eval.inception", "councilx_torch.eval.hook",
                 "councilx_torch.cli.eval", "councilx_torch.cli.fid",
                 "councilx_torch.cli.convert",
                 "councilx_torch.tools.toy_e2e",
                 "councilx_torch.ops.quant",
                 "councilx_torch.ops.upsample_conv",
                 "councilx_torch.tools.calibrate_quant",
                 "councilx_torch.tools.quant_quality",
                 "councilx_torch.nn.vgg",
                 "councilx_torch.tools.export_pt"):
        assert name in r.stdout, name
