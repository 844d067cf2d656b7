"""A tiny Council-GAN configuration for the CPU tests (every width cut: a
test size, not a benchmark configuration)."""

TINY = {
    "batch_size": 2, "lr": 1e-4, "beta1": 0.5, "beta2": 0.999,
    "weight_decay": 1e-4, "lr_policy": "step", "step_size": 100000,
    "gamma": 0.5, "gan_w": 1.0, "recon_x_w": 10.0, "recon_s_w": 1.0,
    "recon_c_w": 1.0, "compute_dtype": "float32",
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 3, "n_downsample": 2,
            "n_res": 2, "activ": "relu", "pad_type": "reflect"},
    "dis": {"dim": 8, "n_layer": 2, "num_scales": 2, "norm": "none",
            "activ": "lrelu", "gan_type": "lsgan", "pad_type": "reflect"},
    "council": {"council_size": 2, "council_w": 0.2,
                "council_start_at_iter": 0},
    "focus_loss": {"focus_enabled": True, "mask_total_w": 0.005,
                   "mask_zero_or_one_w": 0.005},
    "crop_image_height": 32, "crop_image_width": 32,
}


def tiny(focus: bool = True) -> dict:
    cfg = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in TINY.items()}
    cfg["focus_loss"]["focus_enabled"] = focus
    return cfg
