"""Export a port training snapshot to reference-layout torch ``.pt`` files.

Counterpart of ``tools/export_pt.py``:

    python -m councilx_torch.tools.export_pt --config run.yaml \\
        --checkpoint build/prun/run/checkpoints --out build/export

writes ``gen_<step>.pt``, ``dis_<step>.pt`` and ``dis_council_<step>.pt``
(step zero-padded to 8 digits), each ``{"<direction>_<member>":
state_dict}`` over the config's directions, in the reference module naming
(trainer_council.py's save layout), so a council trained with the port
resumes or serves in the original PyTorch tooling, in the JAX package
(``tools/convert_pt.py``) and in the port (``--checkpoint gen_*.pt``).

``--checkpoint`` is a snapshot root (``checkpoints/``, the newest step is
read, as ``ckpt.manager.restore_checkpoint`` reads it), one
``step_XXXXXXXX`` directory or its ``state.pt``. The port's snapshots
already hold MUNIT-layout state dicts, so this copies tensors and converts
nothing; it reads files only and launches nothing on any device.
"""

import argparse
import os
import re
from typing import Any, Dict, Tuple

import torch

from councilx_torch.ckpt.manager import (SNAPSHOT_FILE, load_snapshot,
                                         restore_checkpoint)

# payload file name -> the snapshot's parameter group
FILES = (("gen", "gen"), ("dis", "dis"), ("dis_council", "cdis"))


def read_snapshot(checkpoint: str) -> Tuple[Dict[str, Any], int]:
    """(payload, step) of a snapshot root, step directory or ``state.pt``."""
    if os.path.isfile(checkpoint):
        payload = torch.load(checkpoint, map_location="cpu",
                             weights_only=True)
        return payload, int(payload["step"])
    if re.fullmatch(r"step_\d+", os.path.basename(
            os.path.normpath(checkpoint))):
        payload = load_snapshot(checkpoint)
        return payload, int(payload["step"])
    return restore_checkpoint(checkpoint)


def directions(cfg) -> list:
    """The trained directions, in the trainer's order."""
    return [d for d, on in (("a2b", cfg.do_a2b), ("b2a", cfg.do_b2a)) if on]


def export(cfg, checkpoint: str, out: str) -> Dict[str, str]:
    """Write the three reference-layout files of ``checkpoint`` under
    ``out`` -> {payload name: path}."""
    payload, step = read_snapshot(checkpoint)
    params = payload["params"]
    n = cfg.council.council_size
    files = {}
    os.makedirs(out, exist_ok=True)
    for name, group in FILES:
        members = {}
        for d in directions(cfg):
            if d not in params:
                raise ValueError(f"{checkpoint}: no {d!r} direction (it has "
                                 f"{sorted(params)})")
            sds = params[d][group]
            if len(sds) != n:
                raise ValueError(f"{checkpoint}: {d}/{group} holds "
                                 f"{len(sds)} members, the config {n}")
            members.update({f"{d}_{i}": sd for i, sd in enumerate(sds)})
        path = os.path.join(out, f"{name}_{step:08d}.pt")
        torch.save(members, path)
        files[name] = path
    return files


def main(argv=None) -> Dict[str, str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help=f"snapshot root, step_XXXXXXXX directory or its "
                        f"{SNAPSHOT_FILE}")
    p.add_argument("--out", required=True, help="output directory")
    args = p.parse_args(argv)

    from councilx_torch.config import load_config

    files = export(load_config(args.config), args.checkpoint, args.out)
    for path in files.values():
        print(f"wrote {path}")
    return files


if __name__ == "__main__":
    main()
