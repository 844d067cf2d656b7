"""Reference-checkpoint conversion, the port's counterpart of
``councilx/cli/convert.py``:

    python -m councilx_torch.cli.convert --pt gen_00100000.pt \\
        --config configs/galsses_council_folder.yaml --out gen.npz

Converts a reference Council-GAN generator checkpoint (gen_*.pt, per-member
state dicts) into the ``.npz`` of stacked (N, ...) parameters that the JAX
package (``councilx.ckpt.manager.load_generator_params``) and the port
(``ckpt/manager.py::load_generator_state_dicts``) read. Runs on the CPU.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pt", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True, help=".npz output path")
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    args = p.parse_args(argv)

    from councilx_torch.ckpt.manager import (load_generator_state_dicts,
                                             save_params_npz)
    from councilx_torch.ckpt.torch_convert import state_dicts_to_params
    from councilx_torch.config import load_config

    cfg = load_config(args.config)
    save_params_npz(args.out, state_dicts_to_params(
        load_generator_state_dicts(args.pt, cfg, args.direction), cfg))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
