"""Typed configuration that ingests reference Council-GAN YAMLs verbatim.

Counterpart of ``councilx/config.py``: the same dataclasses, keys, aliases,
defaults and validation, so every YAML loads to the same ``to_dict()`` in
both packages. Flat (``council_size: 4``) and nested
(``council: {council_size: 4}``) spellings are accepted; unknown keys are
kept in ``Config.extras`` so a config round-trips.

Some fields select engines of the JAX package and have no effect in the
port, which has one engine: the kernels at the 3x3 resblock convs and the
IN/AdaIN sites on CUDA tensors, and the plain reference ops everywhere
else. They are parsed and validated so that a config loads unchanged:
``use_pallas``, ``use_pallas_norm``, ``fuse_upsample``, ``boundary_engine``,
``upsample_engine`` and ``resblock_fuse_pad``.

Reference parity: utils.py::get_config, configs/*.yaml (key schema).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

from councilx_torch.schedules import WeightSchedule, extract_schedules

# every schedulable loss weight (canonical name -> accepted YAML aliases);
# any of these may be written as a scalar OR a schedule dict — see
# councilx/schedules.py (SURVEY.md §2.2 "misc config-gated extras")
_WEIGHT_ALIASES: Dict[str, tuple] = {
    "gan_w": ("gan_w",),
    "recon_x_w": ("recon_x_w",),
    "recon_s_w": ("recon_s_w",),
    "recon_c_w": ("recon_c_w",),
    "vgg_w": ("vgg_w",),
    "council_w": ("council_w",),
    "mask_total_w": ("mask_total_w", "mask_size_w"),
    "mask_zero_or_one_w": ("mask_zero_or_one_w", "mask_binary_w"),
    "mask_tv_w": ("mask_tv_w",),
}
# canonical weight keys that live in the council sub-config (the rest are
# top-level Config fields) — used to re-nest schedules in to_dict
_COUNCIL_WEIGHTS = ("council_w", "mask_total_w", "mask_zero_or_one_w",
                    "mask_tv_w")


def _first(d: Dict[str, Any], *names, default=None):
    """Return the first present key among ``names`` (flat lookup)."""
    for n in names:
        if n in d and d[n] is not None:
            return d[n]
    return default


@dataclass
class GenConfig:
    """Generator hyperparameters (reference: networks.py::AdaINGen ctor)."""

    dim: int = 64               # base channel width
    mlp_dim: int = 256          # hidden width of the AdaIN-parameter MLP
    style_dim: int = 8          # style code length
    n_downsample: int = 2       # content-encoder stride-2 stages
    n_res: int = 4              # residual blocks in encoder tail / decoder head
    activ: str = "relu"
    pad_type: str = "reflect"
    mlp_n_blk: int = 3          # MLP depth (reference MUNIT default)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class DisConfig:
    """Discriminator hyperparameters (reference: networks.py::MsImageDis ctor)."""

    dim: int = 64
    norm: str = "none"
    activ: str = "lrelu"
    n_layer: int = 4
    gan_type: str = "lsgan"
    num_scales: int = 3
    pad_type: str = "reflect"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DisConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class CouncilConfig:
    """Council-specific knobs (reference: trainer_council.py council block).

    The reference mount was empty during the survey, so exact key spellings
    are best-effort; every known alias is accepted in :meth:`from_dict`.
    """

    council_size: int = 4
    council_w: float = 0.2
    # iteration after which the mutual-agreement loss switches on
    council_start_at_iter: int = 0
    # council-dis update ratio (reference key ≈
    # numberOfCouncil_dis_relative_iteration) — interpretation is [VERIFY],
    # so BOTH readings are implemented, selected by cdis_ratio_mode:
    #   "k_per_step": k council-dis updates per train step (each on freshly
    #     drawn fakes) — the reading the reference key name suggests; DEFAULT
    #   "every_kth":  one council-dis update on every k-th step (gated by a
    #     traced lax.cond inside the jit — no host sync)
    council_dis_relative_iteration: int = 1
    cdis_ratio_mode: str = "k_per_step"
    # real/fake polarity of the council discriminator ([VERIFY], dual-
    # implemented): "own_real" (D̂_i: member i's own pairs = real class,
    # other members' = fake; generators target the own-class label) or
    # "own_fake" (swapped labels; generators still target the own-class
    # label, which is then 0). Same agreement pressure either way; flip
    # with one config line when the reference source is available.
    council_polarity: str = "own_real"
    # alpha-mask ("focus") mechanism
    focus_enabled: bool = True
    mask_total_w: float = 0.005        # mean(mask) size penalty
    mask_zero_or_one_w: float = 0.005  # binarization penalty mean(mask*(1-mask))
    mask_tv_w: float = 0.0             # total-variation smoothness on the mask
    focus_start_at_iter: int = 0
    # condition the council discriminator on the input image (channel concat)
    council_conditional_input: bool = True
    # mask-channel activation ([VERIFY], dual-implemented):
    #   "tanh_affine": decoder tanh covers the mask channel, mask=(m+1)/2
    #     (round-1 reading; DEFAULT)
    #   "sigmoid": the final conv leaves the mask channel raw (tanh applies
    #     to RGB only) and mask = sigmoid(raw)
    # Same parameter tree either way — flipping is a one-line config change
    # when the reference source is available.
    mask_activation: str = "tanh_affine"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CouncilConfig":
        c = dict(d.get("council", {}) or {})
        f = dict(d.get("focus_loss", {}) or {})
        merged = {**d, **c, **f}
        return cls(
            council_size=int(_first(merged, "council_size", default=4)),
            council_w=float(_first(merged, "council_w", default=0.2)),
            council_start_at_iter=int(
                _first(merged, "council_start_at_iter", "council_start_iteration",
                       default=0)),
            council_dis_relative_iteration=int(
                _first(merged, "council_dis_relative_iteration",
                       "numberOfCouncil_dis_relative_iteration", default=1)),
            cdis_ratio_mode=str(_first(merged, "cdis_ratio_mode",
                                       default="k_per_step")),
            council_polarity=str(_first(merged, "council_polarity",
                                        default="own_real")),
            focus_enabled=bool(_first(merged, "focus_enabled", "do_focus",
                                      "focus", default=True)),
            mask_total_w=float(_first(merged, "mask_total_w", "mask_size_w",
                                      default=0.005)),
            mask_zero_or_one_w=float(
                _first(merged, "mask_zero_or_one_w", "mask_binary_w",
                       default=0.005)),
            mask_tv_w=float(_first(merged, "mask_tv_w", default=0.0)),
            focus_start_at_iter=int(
                _first(merged, "focus_start_at_iter", "focus_loss_start_at_iter",
                       default=0)),
            council_conditional_input=bool(
                _first(merged, "council_conditional_input",
                       "council_abs_gen_input", default=True)),
            mask_activation=str(_first(merged, "mask_activation",
                                       default="tanh_affine")),
        )


@dataclass
class DataConfig:
    """Data pipeline config (reference: utils.py::get_all_data_loaders keys)."""

    data_root: str = "./datasets"
    input_dim_a: int = 3
    input_dim_b: int = 3
    num_workers: int = 4
    new_size: int = 132            # resize shorter side before crop
    crop_image_height: int = 128
    crop_image_width: int = 128
    # read by nothing, in the port as in the JAX package: the train loop
    # always crops and flips on the device (data/ondevice.py); kept so
    # configs load unchanged
    on_device_aug: bool = True

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        sub = dict(d.get("data", {}) or {})
        merged = {**d, **sub}
        return cls(**{k: v for k, v in merged.items() if k in known})


@dataclass
class Config:
    """Full training/inference configuration.

    Field names follow the reference YAML keys (SURVEY.md §5.6) so reference
    configs load unchanged via :func:`load_config`.
    """

    # --- logger block -----------------------------------------------------
    image_save_iter: int = 10_000
    image_display_iter: int = 500
    display_size: int = 8
    # in-training FID cadence (0 = off, the default — and the reference
    # behavior): every eval_iter steps, translate a fixed test batch with
    # eval_member and log fid_<direction> vs the target test split
    # (councilx_torch/eval/hook.py). Needs eval_inception_weights.
    eval_iter: int = 0
    # InceptionV3 .npz (tools/convert_inception_pt.py) or torchvision /
    # pytorch-fid state dict (.pt/.pth); the literal "random" permits
    # random weights for smoke tests (numbers meaningless)
    eval_inception_weights: str = ""
    # images per domain used by the in-training FID (bounds eval cost)
    eval_max_images: int = 64
    # council member the in-training FID scores: an index, or "all" for the
    # paper's best-member protocol — per-member fid_<dir>_m<k> series plus
    # fid_<dir> = min over members (the number the paper reports)
    eval_member: Any = 0
    snapshot_save_iter: int = 10_000
    log_iter: int = 10

    # --- optimization -----------------------------------------------------
    max_iter: int = 1_000_000
    batch_size: int = 4
    lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.999
    weight_decay: float = 1e-4
    init: str = "kaiming"
    lr_policy: str = "step"
    step_size: int = 100_000
    gamma: float = 0.5

    # --- loss weights (MUNIT-inherited) -----------------------------------
    gan_w: float = 1.0
    recon_x_w: float = 10.0
    recon_s_w: float = 1.0
    recon_c_w: float = 1.0
    recon_x_cyc_w: float = 0.0   # cycle consistency removed — the paper's point
    vgg_w: float = 0.0

    # --- direction flags ---------------------------------------------------
    do_a2b: bool = True
    do_b2a: bool = False

    # --- sub-blocks ---------------------------------------------------------
    gen: GenConfig = field(default_factory=GenConfig)
    dis: DisConfig = field(default_factory=DisConfig)
    council: CouncilConfig = field(default_factory=CouncilConfig)
    data: DataConfig = field(default_factory=DataConfig)

    # --- additions beyond the reference YAML schema ------------------------
    # Every field below exists in councilx/config.py with the same default;
    # the comment says what it does in the port.
    # compute dtype of the forward pass ("bfloat16" or "float32");
    # parameters stay float32 and are cast at use.
    compute_dtype: str = "bfloat16"
    # internal precision of the MUNIT LayerNorm under bfloat16 compute
    # ("f32" | "mixed" | "bf16", see nn.blocks.MunitLayerNorm). The IN/AdaIN
    # sites always take f32 statistics and one cast at the end (the
    # instance-norm kernel's numerics). Forced to "f32" in parity_mode.
    in_precision: str = "mixed"
    # mean/var reduction scheme of the MUNIT LayerNorm ("one_pass" |
    # "two_pass", see nn.blocks.norm_mean_var); the IN/AdaIN sites are
    # always two-pass. Forced to "two_pass" in parity_mode.
    norm_stats: str = "one_pass"
    # W8A8 serving quantization: not ported yet; the port's Translator
    # rejects anything but "none" outside parity_mode.
    quant: str = "none"
    quant_scope: str = "resblocks"
    # engine selectors of the JAX package; no effect in the port
    boundary_engine: str = "auto"
    upsample_engine: str = "dilated"
    resblock_fuse_pad: bool = False
    # parity mode: float32 everywhere and two-pass f32 statistics, for
    # comparison against the reference inference path.
    parity_mode: bool = False
    # kernel toggles of the JAX package; no effect in the port, which runs
    # its kernels at every kernel site of a CUDA tensor
    use_pallas: bool = False
    use_pallas_norm: bool = False
    # exact upsample+conv rewrite of the JAX package; no effect in the port
    fuse_upsample: bool = True
    # --- training, data-parallel and memory settings -------------------
    # stage step k+1's batches in a worker thread while step k runs
    # (train/loop.py)
    host_prefetch: bool = True
    # multi-device training: the train loop refuses num_devices > 1,
    # council_parallel > 1 and det_data_reduction (not ported yet)
    num_devices: int = 1
    council_parallel: int = 1
    det_data_reduction: bool = False
    remat: bool = False
    remat_stages: bool = False
    adam_mu_dtype: str = "float32"
    gen_member_chunks: int = 1
    skip_nonfinite_updates: bool = False
    # one style draw per direction per step (legacy bool, superseded by
    # z_mode; kept so existing configs load unchanged)
    shared_z: bool = True
    # z-stream mode: "shared" | "dis_shared" | "per_phase"; None derives it
    # from shared_z (True -> "shared", False -> "dis_shared")
    z_mode: Any = None

    # non-constant loss-weight schedules by canonical weight name (the typed
    # weight fields above hold each schedule's peak ``base``; constant
    # weights never appear here) — see councilx_torch/schedules.py
    loss_schedules: Dict[str, WeightSchedule] = field(default_factory=dict)

    # unknown YAML keys, preserved verbatim
    extras: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        # resolve the legacy shared_z bool into z_mode for directly
        # constructed Configs too (from_dict additionally runs validate())
        if self.z_mode is None:
            self.z_mode = "shared" if self.shared_z else "dis_shared"

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        raw = dict(raw or {})
        schedules = extract_schedules(raw, _WEIGHT_ALIASES)
        known = {f.name for f in dataclasses.fields(cls)
                 if f.name not in ("gen", "dis", "council", "data", "extras",
                                   "loss_schedules")}
        kwargs: Dict[str, Any] = {k: v for k, v in raw.items() if k in known}
        kwargs["gen"] = GenConfig.from_dict(dict(raw.get("gen", {}) or {}))
        kwargs["dis"] = DisConfig.from_dict(dict(raw.get("dis", {}) or {}))
        kwargs["council"] = CouncilConfig.from_dict(raw)
        kwargs["data"] = DataConfig.from_dict(raw)
        kwargs["loss_schedules"] = schedules
        consumed = known | {"gen", "dis", "council", "focus_loss", "data",
                            "loss_schedules"}
        kwargs["extras"] = {k: v for k, v in raw.items() if k not in consumed}
        cfg = cls(**kwargs)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.z_mode is None:
            self.z_mode = "shared" if self.shared_z else "dis_shared"
        if self.z_mode not in ("shared", "dis_shared", "per_phase"):
            raise ValueError(f"unsupported z_mode: {self.z_mode}")
        if self.council.council_size < 1:
            raise ValueError("council_size must be >= 1")
        if self.gen.n_downsample < 2:
            raise ValueError("n_downsample must be >= 2 (style encoder doubles "
                             "channels on its first two downsamples)")
        if self.dis.gan_type not in ("lsgan", "nsgan"):
            raise ValueError(f"unsupported gan_type: {self.dis.gan_type}")
        if self.council.cdis_ratio_mode not in ("k_per_step", "every_kth"):
            raise ValueError(
                f"unsupported cdis_ratio_mode: {self.council.cdis_ratio_mode}")
        if self.council.council_polarity not in ("own_real", "own_fake"):
            raise ValueError(
                f"unsupported council_polarity: {self.council.council_polarity}")
        if self.council.mask_activation not in ("tanh_affine", "sigmoid"):
            raise ValueError(
                f"unsupported mask_activation: {self.council.mask_activation}")
        if not (self.do_a2b or self.do_b2a):
            raise ValueError("at least one of do_a2b / do_b2a must be true")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unsupported compute_dtype: {self.compute_dtype}")
        if self.in_precision not in ("f32", "mixed", "bf16"):
            raise ValueError(f"unsupported in_precision: {self.in_precision}")
        if self.norm_stats not in ("two_pass", "one_pass"):
            raise ValueError(f"unsupported norm_stats: {self.norm_stats}")
        if self.quant not in ("none", "w8a8", "w8a8_calib", "w8a8_static"):
            raise ValueError(f"unsupported quant: {self.quant}")
        if self.quant_scope not in ("heavy", "resblocks"):
            raise ValueError(f"unsupported quant_scope: {self.quant_scope}")
        if self.boundary_engine not in ("auto", "phase_fused", "phase",
                                        "strips", "reference"):
            raise ValueError(
                f"unsupported boundary_engine: {self.boundary_engine}")
        if self.upsample_engine not in ("dilated", "phase", "ln_fused"):
            raise ValueError(
                f"unsupported upsample_engine: {self.upsample_engine}")
        if not (self.eval_member == "all"
                or (isinstance(self.eval_member, int)
                    and 0 <= self.eval_member < self.council.council_size)):
            raise ValueError(
                f"eval_member must be 'all' or a member index in "
                f"[0, {self.council.council_size}), got {self.eval_member!r}")
        if self.gen_member_chunks < 1:
            raise ValueError("gen_member_chunks must be >= 1")
        if self.council.council_size % self.gen_member_chunks:
            raise ValueError(
                f"gen_member_chunks {self.gen_member_chunks} must divide "
                f"council_size {self.council.council_size}")
        if self.recon_x_cyc_w:
            # cycle consistency is what Council-GAN removes (the paper's
            # thesis); the key exists for YAML compatibility but must be 0
            raise ValueError(
                "recon_x_cyc_w > 0: cycle consistency is intentionally "
                "unimplemented (Council-GAN replaces it with the council "
                "agreement loss); set it to 0")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extras = d.pop("extras")
        d.pop("loss_schedules")
        d.update(extras)
        # re-emit non-constant weights as schedule dicts where they came
        # from (council-block weights nested, the rest top-level) so the
        # dict round-trips through from_dict
        for canon, sched in self.loss_schedules.items():
            target = d["council"] if canon in _COUNCIL_WEIGHTS else d
            target[canon] = sched.to_value()
        return d

    # convenience aliases used across the codebase
    @property
    def council_size(self) -> int:
        return self.council.council_size

    @property
    def image_size(self) -> int:
        return self.data.crop_image_height


def load_config(path: str) -> Config:
    """Load a (reference-format or councilx) YAML config file.

    Reference parity: utils.py::get_config — but typed + validated instead of
    a raw dict.
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return Config.from_dict(raw)
