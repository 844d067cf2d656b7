"""End-to-end functional check on a synthetic glasses-removal task.

Counterpart of ``tools/toy_e2e.py``. Generates two unpaired domains of
smooth random "face-like" images — domain A carries a dark horizontal bar
("glasses"), domain B is clean — trains the full council (focus mask on)
for a few hundred steps through the port's train loop, then checks that
the learned translation removes the bar: the pixel change inside the bar
band must be more than twice the change outside, and the focus mask must
open more inside the band than outside.

    python -m councilx_torch.tools.toy_e2e [--steps 600] [--out build/toy]
        [--device cuda]

No dataset download. Prints one JSON line with the verdict metrics and
``pass``. ``--device`` defaults to the card.
"""

import argparse
import json
import os

import numpy as np

BAR = (26, 38)  # bar rows in the 64px image (scaled to the train size)


def _smooth_noise(rng, size, octaves=3):
    img = np.zeros((size, size, 3), np.float32)
    for o in range(octaves):
        s = 4 * (2 ** o)
        coarse = rng.rand(s, s, 3).astype(np.float32)
        zoom = size // s
        img += np.kron(coarse, np.ones((zoom, zoom, 1), np.float32)) / (o + 1)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def make_dataset(root, n_train=256, n_test=32, size=64, seed=0):
    """trainA/B and testA/B PNG folders under ``root``; A with the bar."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    r0, r1 = BAR[0] * size // 64, BAR[1] * size // 64  # scale with size
    m = 8 * size // 64
    for split, n in (("trainA", n_train), ("trainB", n_train),
                     ("testA", n_test), ("testB", n_test)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        with_bar = split.endswith("A")
        for i in range(n):
            img = _smooth_noise(rng, size)
            if with_bar:
                img[r0:r1, m:-m] *= 0.15  # dark "glasses" bar
            arr = (img * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:05d}.png"))


def verdict(x: np.ndarray, x_t: np.ndarray, mask, size: int,
            prefix: str):
    """(metrics, ok) of one direction's edit: x (B,H,W,3) inputs, x_t
    (N,B,H,W,3) every member's translation, mask (N,B,H,W,1) or None, all
    in [-1, 1] floats. ok: the change inside the bar band is more than
    twice the change outside it and, with a mask, the mask opens more
    inside than outside."""
    bar = slice(BAR[0] * size // 64, BAR[1] * size // 64)
    m = 8 * size // 64
    diff = np.abs(x_t - x[None]).mean(axis=(0, 1, 4))  # (H, W)
    change_in = float(diff[bar, m:-m].mean())
    change_out = float(np.concatenate(
        [diff[:bar.start], diff[bar.stop:]]).mean())
    out = {prefix + "change_in_bar": round(change_in, 4),
           prefix + "change_outside": round(change_out, 4),
           prefix + "edit_locality": round(change_in / max(change_out, 1e-6),
                                           2)}
    ok = change_in > 2 * change_out
    if mask is not None:
        mask_map = mask.mean(axis=(0, 1, 4))
        mask_in = float(mask_map[bar, m:-m].mean())
        mask_out = float(np.concatenate(
            [mask_map[:bar.start], mask_map[bar.stop:]]).mean())
        out[prefix + "mask_in_bar"] = round(mask_in, 4)
        out[prefix + "mask_outside"] = round(mask_out, 4)
        out[prefix + "mask_locality"] = round(mask_in / max(mask_out, 1e-6),
                                              2)
        ok = ok and mask_in > mask_out
    return out, bool(ok)


def toy_config(args, data_root: str) -> dict:
    """The JAX tool's configuration, from its flags."""
    return {
        "batch_size": args.batch, "compute_dtype": "bfloat16",
        "lr": 1e-4, "log_iter": 50,
        "image_save_iter": 0, "image_display_iter": 0,
        "snapshot_save_iter": args.steps,
        "max_iter": args.steps,
        "do_a2b": args.directions in ("a2b", "both"),
        "do_b2a": args.directions in ("b2a", "both"),
        "shared_z": bool(args.shared_z),
        **({"z_mode": args.z_mode} if args.z_mode else {}),
        **({"gen_member_chunks": args.gen_member_chunks}
           if args.gen_member_chunks > 1 else {}),
        **({"in_precision": args.in_precision}
           if args.in_precision else {}),
        "recon_x_w": 10.0, "recon_s_w": 1.0, "recon_c_w": 1.0,
        "council": {"council_size": args.council, "council_w": 0.2,
                    "council_start_at_iter": 0,
                    "council_dis_relative_iteration": args.cdis_ratio,
                    "cdis_ratio_mode": args.cdis_ratio_mode,
                    "mask_activation": args.mask_activation},
        "focus_loss": {
            "focus_enabled": not args.no_focus,
            "mask_total_w": ({"base": 0.05,
                              "start_at_iter": args.mask_w_start}
                             if args.mask_w_start else 0.05),
            "mask_zero_or_one_w": ({"base": 0.01,
                                    "start_at_iter": args.mask_w_start}
                                   if args.mask_w_start else 0.01)},
        "gen": {"dim": 32, "mlp_dim": 128, "style_dim": 8,
                "n_downsample": 2, "n_res": 2},
        "dis": {"dim": 32, "n_layer": 3, "num_scales": 2},
        "new_size": args.size, "crop_image_height": args.size,
        "crop_image_width": args.size,
        "data_root": data_root, "num_workers": 4,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=os.path.join("build", "toy_e2e"))
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--council", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--directions", default="a2b",
                    choices=["a2b", "b2a", "both"],
                    help="a2b removes the bar; b2a learns to ADD it "
                         "(reference do_a2b/do_b2a flags)")
    ap.add_argument("--cdis_ratio", type=int, default=1,
                    help="council_dis_relative_iteration")
    ap.add_argument("--cdis_ratio_mode", default="k_per_step",
                    choices=["k_per_step", "every_kth"])
    ap.add_argument("--resume_mid", action="store_true",
                    help="stop at steps/2, resume from the snapshot, finish "
                         "— checks checkpoint/resume mid-training")
    ap.add_argument("--shared_z", type=int, default=1)
    ap.add_argument("--z_mode", default=None,
                    choices=["shared", "dis_shared", "per_phase"],
                    help="overrides --shared_z when given")
    ap.add_argument("--gen_member_chunks", type=int, default=1,
                    help="chunk the generator update over the council axis "
                         "— shows that the chunked step trains")
    ap.add_argument("--in_precision", default=None,
                    choices=["f32", "mixed", "bf16"],
                    help="the LayerNorm's internal precision (None = Config "
                         "default)")
    ap.add_argument("--mask_activation", default="tanh_affine",
                    choices=["tanh_affine", "sigmoid"])
    ap.add_argument("--mask_w_start", type=int, default=0,
                    help="start the mask size/binary penalties only at this "
                         "step (weight schedules end to end)")
    ap.add_argument("--no_focus", action="store_true",
                    help="disable the focus mask. Needed for the b2a "
                         "(bar-addition) task: with focus on, recon_x "
                         "drives the mask to 0 within ~50 steps and the "
                         "rgb branch gets no gradient where the mask is "
                         "closed, so an addition never bootstraps")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from councilx_torch.ckpt.manager import restore_checkpoint
    from councilx_torch.config import Config
    from councilx_torch.data.dataset import ImageFolderDataset
    from councilx_torch.train.loop import make_trainer, train
    from councilx_torch.utils.images import save_image_grid

    data_root = os.path.join(args.out, "data")
    make_dataset(data_root, size=args.size)
    cfg = Config.from_dict(toy_config(args, data_root))

    if args.resume_mid:
        half = args.steps // 2
        summary = train(cfg, output_path=args.out, run_name="toy",
                        max_steps=half, device=args.device)
        if summary["step"] != half:
            raise RuntimeError(f"first half ended at {summary}")
        summary = train(cfg, output_path=args.out, run_name="toy",
                        resume=True, device=args.device)
        if summary["step"] != args.steps:
            raise RuntimeError(f"resume did not continue to {args.steps}: "
                               f"{summary}")
    else:
        summary = train(cfg, output_path=args.out, run_name="toy",
                        max_steps=args.steps, device=args.device)

    # per trained direction, measure the edit (bar removal for a2b, bar
    # addition for b2a) and the mask's focus inside the bar band
    trainer = make_trainer(cfg, args.device)
    payload, step = restore_checkpoint(
        os.path.join(args.out, "toy", "checkpoints"))
    state = trainer.restore_state(payload)
    out = {
        "metric": "toy_glasses_removal_e2e",
        "steps": int(step),
        "directions": args.directions,
        "cdis_ratio": args.cdis_ratio,
        "cdis_ratio_mode": args.cdis_ratio_mode,
        "resume_mid": bool(args.resume_mid),
        "images_per_sec": round(summary["images_per_sec"], 2),
    }
    ok = True
    for direction in trainer.directions:
        src = "testA" if direction == "a2b" else "testB"
        ds = ImageFolderDataset(os.path.join(data_root, src),
                                new_size=args.size)
        xs = np.stack([ds[i] for i in range(16)])
        x = (xs.astype(np.float32) - 127.5) / 127.5
        z = torch.randn((trainer.n, x.shape[0], cfg.gen.style_dim),
                        generator=torch.Generator().manual_seed(1))
        x_t, mask = trainer.sample(state, x, direction=direction, z=z)
        x_t = x_t.float().cpu().numpy()                       # (N,B,H,W,3)
        mask = mask.float().cpu().numpy() if mask is not None else None
        save_image_grid(
            os.path.join(args.out, f"toy_samples_{direction}.jpg"),
            np.concatenate([x, x_t[0], x_t[-1]]), nrow=16)
        metrics, ok_dir = verdict(x, x_t, mask, args.size, f"{direction}_")
        out.update(metrics)
        ok = ok and ok_dir
    out["pass"] = bool(ok)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
