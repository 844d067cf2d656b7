"""Quality gate for quantized serving: unquantized vs W8A8 on a checkpoint.

Counterpart of ``tools/quant_quality.py``: translates the same inputs
with the same style codes through the ``quant: none`` serving path and
each quantized mode, and reports per-image PSNR and uint8-level deltas of
the outputs a client would receive.

    python -m councilx_torch.tools.quant_quality --config cfg.yaml \
        --checkpoint gen.pt --calibration quant_stats.npz \
        [--input_folder imgs/] [--modes w8a8_static,w8a8] \
        [--sheet side_by_side.jpg] [--device cuda]

Prints one JSON line per mode:
  {"mode": "w8a8_static", "psnr_mean_db": ..., "psnr_min_db": ...,
   "maxabs_u8": ..., "meanabs_u8": ..., "images": N}

The JAX package's test holds its gate at psnr_min_db > 20, maxabs_u8 <
128 and meanabs_u8 < 8. Style codes come from a ``torch.Generator``
seeded with ``--seed``; noise inputs from ``np.random.RandomState``.
"""

import argparse
import json

import numpy as np
import torch

PSNR_CAP_DB = 99.0   # identical images report this, keeping the JSON finite


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB between two uint8 images (PSNR_CAP_DB when identical)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0.0:
        return PSNR_CAP_DB
    return min(PSNR_CAP_DB, 10.0 * np.log10(255.0 ** 2 / mse))


def compare(cfg_path: str, checkpoint: str, member: int, direction: str,
            modes, calibration=None, input_folder=None, batch_size=8,
            num_batches=4, seed=0, sheet_path=None, device="cuda"):
    """Translate identical (x, z) through quant 'none' and each mode of
    ``modes``; return {mode: metrics dict} of the uint8 outputs. With
    ``sheet_path``, also save an [input | none | mode...] JPEG of the first
    batch."""
    from councilx_torch.ckpt.manager import (load_generator_state_dicts,
                                             load_params_npz)
    from councilx_torch.config import load_config
    from councilx_torch.inference.translate import Translator
    from councilx_torch.tools.calibrate_quant import calibration_batches

    if "w8a8_static" in modes and calibration is None:
        raise SystemExit("--calibration is required for w8a8_static "
                         "(councilx_torch.tools.calibrate_quant)")
    cfg = load_config(cfg_path)
    cfg.quant = "none"
    sd = load_generator_state_dicts(checkpoint, cfg, direction)[member]
    runs = {}
    for mode in ["none"] + list(modes):
        mcfg = load_config(cfg_path)
        mcfg.quant = mode
        stats = (load_params_npz(calibration) if mode == "w8a8_static"
                 else None)
        tr = Translator(mcfg, quant_stats=stats, device=device)
        runs[mode] = (tr, tr.load_members([sd])[0])

    rng = torch.Generator().manual_seed(seed)
    per_mode = {m: {"psnr": [], "absdiff": []} for m in modes}
    n_images = 0
    sheet_rows = None
    batches = calibration_batches(cfg, input_folder, batch_size,
                                  num_batches, seed)
    for b, x in enumerate(batches):
        z = torch.randn((x.shape[0], cfg.gen.style_dim), generator=rng)
        tr, gen = runs["none"]
        ref = tr.translate_u8(gen, x, z=z)
        n_images += x.shape[0]
        if b == 0 and sheet_path:
            sheet_rows = [((x + 1.0) * 127.5).astype(np.uint8), ref]
        for mode in modes:
            tr, gen = runs[mode]
            out = tr.translate_u8(gen, x, z=z)
            d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            per_mode[mode]["absdiff"].append(d)
            per_mode[mode]["psnr"].extend(
                psnr_u8(out[i], ref[i]) for i in range(out.shape[0]))
            if b == 0 and sheet_path:
                sheet_rows.append(out)

    if sheet_path and sheet_rows is not None:
        from councilx_torch.utils.images import save_image_grid

        sheet = np.concatenate([np.concatenate(list(row), axis=1)
                                for row in sheet_rows], axis=0)
        save_image_grid(sheet_path, sheet[None], nrow=1)

    results = {}
    for mode in modes:
        psnr = np.array(per_mode[mode]["psnr"])
        d = np.concatenate([a.reshape(a.shape[0], -1)
                            for a in per_mode[mode]["absdiff"]], axis=0)
        results[mode] = {
            "mode": mode,
            "psnr_mean_db": round(float(np.mean(psnr)), 2),
            "psnr_min_db": round(float(np.min(psnr)), 2),
            "maxabs_u8": int(d.max()),
            "meanabs_u8": round(float(d.mean()), 3),
            "images": int(n_images),
        }
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--member", type=int, default=0)
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    p.add_argument("--calibration", default=None,
                   help="quant_stats .npz (required for w8a8_static)")
    p.add_argument("--input_folder", default=None,
                   help="eval images; omit for seeded noise")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--modes", default="w8a8_static",
                   help="comma-separated: w8a8_static and/or w8a8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sheet", default=None,
                   help="save an [input | none | quant...] comparison JPEG "
                        "of the first batch")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    for m in modes:
        if m not in ("w8a8", "w8a8_static"):
            raise SystemExit(f"unknown quant mode {m!r}")
    results = compare(args.config, args.checkpoint, args.member,
                      args.direction, modes, calibration=args.calibration,
                      input_folder=args.input_folder,
                      batch_size=args.batch_size,
                      num_batches=args.num_batches, seed=args.seed,
                      sheet_path=args.sheet, device=args.device)
    for mode in modes:
        print(json.dumps(results[mode]), flush=True)
    if args.sheet:
        print(f"sheet -> {args.sheet}", flush=True)
    return results


if __name__ == "__main__":
    main()
