"""chip_smoke.py's bound arithmetic, and its refusal (and
time_norm_forward.py's and time_quant.py's) to run without a card;
profile_port.py's classes of kernel names.

chip_smoke imports only torch, numpy and councilx_torch. The least time it
prints beside each kernel's measured time is computed from shapes alone,
so it is held here against values worked out by hand: bf16 at the main
path's shapes, each input read once and each output written once, against
989 TFLOP/s (tensor cores) and 3.35 TB/s.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import profile_port
import time_norm_forward
import time_quant

CONV = (8, 64, 64, 256, 256)        # xp (8, 66, 66, 256), k (3, 3, 256, 256)


@pytest.mark.parametrize("name,shape,ms,by", [
    # 2 * 32768 * 2304 * 256 = 38.65 GFLOP (35.8 MB) at 989 TFLOP/s
    ("conv3x3", CONV, 0.03908, "operations"),
    ("conv3x3_dgrad", CONV, 0.03908, "operations"),
    ("conv3x3_wgrad", CONV, 0.03908, "operations"),
    # x read and y written, 2 x 16.78 MB, + 16 KB of f32 mean and rstd
    ("instance_norm", (8, 64, 64, 256), 0.01002, "bytes"),
    ("instance_norm", (8, 128, 128, 128), 0.02003, "bytes"),
    ("instance_norm", (8, 256, 256, 64), 0.04007, "bytes"),
    # serving's bucket 64: 2 x 134.2 MB + 131 KB
    ("instance_norm", chip_smoke.NORM_BUCKET64, 0.08017, "bytes"),
    ("adain", (8, 64, 64, 256), 0.01003, "bytes"),
    # dy and x read, dx written: 3 x 16.78 MB at (8, 64, 64, 256)
    ("instance_norm_bwd", (8, 64, 64, 256), 0.01503, "bytes"),
    ("instance_norm_bwd", (8, 128, 128, 128), 0.03005, "bytes"),
    ("instance_norm_bwd", (8, 256, 256, 64), 0.06010, "bytes"),
    ("adain_bwd", (8, 64, 64, 256), 0.01504, "bytes"),
    # the repaired inputs: the norm backward at batch 128, 3 x 268.4 MB +
    # 262 KB (655 KB with the affine); the conv at C = 12, O = 20,
    # 141.6 MFLOP against 2.15 MB of xp, y and k
    ("instance_norm_bwd", chip_smoke.NORM_BWD_BATCH128, 0.2405, "bytes"),
    ("adain_bwd", chip_smoke.NORM_BWD_BATCH128, 0.2406, "bytes"),
    ("conv3x3", chip_smoke.CONV_RAGGED, 0.0006422, "bytes"),
    ("conv3x3_wgrad", chip_smoke.CONV_RAGGED, 0.0006422, "bytes"),
    # the W8A8 sites, int8 at 1,979 TOPS: the resblock conv's 38.65 G
    # operations; down 1 moves 34.08 MB of padded int8 x and writes
    # 33.55 MB of bf16 y; down 2 34.36 G operations; the upsample phase
    # convs 77.31 G each
    ("conv_int8", chip_smoke.QUANT_SITES["resblock"], 0.01953, "operations"),
    ("conv_int8", chip_smoke.QUANT_SITES["down1"], 0.02023, "bytes"),
    ("conv_int8", chip_smoke.QUANT_SITES["down2"], 0.01736, "operations"),
    ("conv_int8", chip_smoke.QUANT_SITES["up1"], 0.03906, "operations"),
    ("conv_int8", chip_smoke.QUANT_SITES["up2"], 0.03906, "operations"),
    # Q2 at the resblock site: 16.78 MB of bf16 read, 8.92 MB of padded
    # int8 written; the per-image mode counts x once too
    ("quant_act", ((8, 64, 64, 256), 1), 0.007671, "bytes"),
    ("quant_act_dynamic", ((8, 64, 64, 256), 1), 0.007671, "bytes"),
    # the conv engines' shapes: each upsample phase conv 77.31 G
    # operations (to 4x the block's outputs), the resblock conv at pad 1
    # (unpadded x) 38.65 G
    ("conv3x3", chip_smoke.PHASE_CONV_SITES["up1"], 0.07817, "operations"),
    ("conv3x3_dgrad", chip_smoke.PHASE_CONV_SITES["up2"], 0.07817,
     "operations"),
    ("conv3x3_wgrad", chip_smoke.PHASE_CONV_SITES["up2"], 0.07817,
     "operations"),
    ("conv3x3_same_zero", chip_smoke.PAD1_SITE, 0.03908, "operations"),
    ("conv3x3_dgrad_pad1", chip_smoke.PAD1_SITE, 0.03908, "operations"),
    ("conv3x3_wgrad_pad1", chip_smoke.PAD1_SITE, 0.03908, "operations"),
])
def test_bound_matches_the_hand_arithmetic(name, shape, ms, by):
    got, got_by = chip_smoke.bound_ms(name, shape)
    # the hand values carry 4 significant digits
    assert got == pytest.approx(ms, rel=1e-3)
    assert got_by == by


def test_conv_work_counts_each_tensor_once():
    ops, nbytes, kind = chip_smoke.kernel_work("conv3x3", CONV)
    assert ops == 2 * (8 * 64 * 64) * (9 * 256) * 256
    assert round(ops / 1e9, 2) == 38.65
    # xp 17.84 MB + y 16.78 MB + k 1.18 MB
    assert nbytes == 2 * (8 * 66 * 66 * 256 + 8 * 64 * 64 * 256
                          + 9 * 256 * 256)
    assert round(nbytes / 1e6, 1) == 35.8
    assert kind == "bf16"
    # f32 (parity mode): twice the bytes, against the f32 FMA rate
    ops32, nbytes32, kind32 = chip_smoke.kernel_work("conv3x3", CONV, 4)
    assert (ops32, nbytes32, kind32) == (ops, 2 * nbytes, "f32")


def test_pad1_work_reads_the_unpadded_input():
    ops, nbytes, _ = chip_smoke.kernel_work("conv3x3_same_zero",
                                            chip_smoke.PAD1_SITE)
    assert ops == chip_smoke.kernel_work("conv3x3", CONV)[0]
    # x 16.78 MB (no padded copy) + y 16.78 MB + k 1.18 MB
    assert nbytes == 2 * (2 * 8 * 64 * 64 * 256 + 9 * 256 * 256)


def _count_k1(monkeypatch):
    """Counts K1's forward calls (at pad 0 or 1) on the CPU, where the
    wrappers run their plain versions and count no launch."""
    from councilx_torch.ops import conv3x3 as conv_ops
    calls = []
    real = conv_ops._forward

    def forward(x, k, pad=0):
        calls.append(pad)
        return real(x, k, pad)

    monkeypatch.setattr(conv_ops, "_forward", forward)
    return calls


ENGINE_RAW = {"compute_dtype": "float32", "council": {"council_size": 2},
              "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 8,
                      "n_downsample": 2, "n_res": 4},
              "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
              "batch_size": 1, "crop_image_height": 32,
              "crop_image_width": 32}


@pytest.mark.parametrize("setting", [n for n, _ in chip_smoke.ENGINE_SERVE])
def test_engine_conv_per_fwd_is_the_generators_k1_sites(monkeypatch,
                                                        setting):
    """The engines phase's K1 launches per serving forward are the K1 calls
    of one port forward (n_res 4) under the same settings, every resblock
    conv at pad 1 under resblock_fuse_pad."""
    from councilx_torch.config import Config
    from councilx_torch.inference.translate import Translator

    over = dict(chip_smoke.ENGINE_SERVE)[setting]
    tr = Translator(Config.from_dict({**ENGINE_RAW, **over}), device="cpu")
    gen = tr.init_members(1, seed=0)[0]
    calls = _count_k1(monkeypatch)
    tr.translate(gen, np.zeros((1, 32, 32, 3), np.float32),
                 np.zeros((1, 8), np.float32))
    assert len(calls) == chip_smoke.engine_conv_per_fwd(over)
    assert calls.count(1) == (16 if over.get("resblock_fuse_pad") else 0)


@pytest.mark.parametrize("setting", [n for n, _ in chip_smoke.ENGINE_TRAIN])
def test_engine_train_conv_is_the_steps_k1_sites(monkeypatch, setting):
    """The engines phase's K1 sites per member and train step are the K1
    calls of one port train step (council-2, n_res 4) under the same
    settings."""
    from councilx_torch.config import Config
    from councilx_torch.train.trainer import CouncilTrainer

    over = dict(chip_smoke.ENGINE_TRAIN)[setting]
    trainer = CouncilTrainer(Config.from_dict({**ENGINE_RAW, **over}),
                             device="cpu")
    state = trainer.init_state(seed=0)
    x = np.zeros((1, 32, 32, 3), np.float32)
    calls = _count_k1(monkeypatch)
    trainer.train_step(state, x, x)
    assert len(calls) == 2 * chip_smoke.engine_train_conv(over)


def _count_pads(monkeypatch):
    """Counts P1's and P1''s calls on the CPU, where ``pad_nhwc`` runs the
    gather: the gather wrapped in an autograd function that counts its
    forward and, as P1' does, its backward. Q2 pads inside its own kernel
    on the card, so the CPU quantize's pad is not counted."""
    from councilx_torch.ops import pad as pad_ops
    from councilx_torch.ops import quant as quant_ops

    calls = {"pad_nhwc": 0, "pad_fold": 0}
    real, real_quant = pad_ops.pad_reference, quant_ops.quantize_act_reference
    quantizing = []

    class Counted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, p, pad_type):
            calls["pad_nhwc"] += 1
            ctx.fold = (x.shape[1], x.shape[2], p, pad_type)
            return real(x, p, pad_type)

        @staticmethod
        def backward(ctx, dy):
            calls["pad_fold"] += 1
            return pad_ops.pad_fold_reference(dy, *ctx.fold), None, None

    def pad_reference(x, p, pad_type):
        if quantizing:
            return real(x, p, pad_type)
        return Counted.apply(x, p, pad_type)

    def quantize_act_reference(*args, **kwargs):
        quantizing.append(True)
        try:
            return real_quant(*args, **kwargs)
        finally:
            quantizing.pop()

    monkeypatch.setattr(pad_ops, "pad_reference", pad_reference)
    monkeypatch.setattr(quant_ops, "quantize_act_reference",
                        quantize_act_reference)
    return calls


# the flagship and headline models at 64 px with width 32: every conv but
# the image's keeps more than 16 channels, as at full width, so each takes
# the same engine
PAD_WIDTHS = {"crop_image_height": 64, "crop_image_width": 64,
              "new_size": 72, "batch_size": 1}


def _narrow(raw: dict) -> dict:
    return {**raw, **PAD_WIDTHS, "gen": {**raw["gen"], "dim": 32},
            "dis": {**raw["dis"], "dim": 32}}


@pytest.mark.parametrize("setting,over,want", [
    *[(n, o, chip_smoke.ENGINE_SERVE_PADS[n])
      for n, o in chip_smoke.ENGINE_SERVE],
    *[(f"quant {scope}", {"quant": "w8a8", "quant_scope": scope},
       chip_smoke.QUANT_PAD_PER_FWD[scope])
      for scope in chip_smoke.QUANT_SCOPES]])
def test_pad_per_fwd_is_the_generators_pad_sites(monkeypatch, setting,
                                                 over, want):
    """P1's launches per member forward that phases 4, 9, 10 and the
    engines phase hold the card to are the pads of one port forward of the
    flagship model under the same settings, and none of them folds."""
    from councilx_torch.config import Config
    from councilx_torch.inference.translate import Translator

    tr = Translator(Config.from_dict(_narrow({**chip_smoke.FLAGSHIP,
                                              **over})), device="cpu")
    gen = tr.init_members(1, seed=0)[0]
    calls = _count_pads(monkeypatch)
    tr.translate(gen, np.zeros((1, 64, 64, 3), np.float32),
                 np.zeros((1, 8), np.float32))
    assert calls == {"pad_nhwc": want, "pad_fold": 0}
    if setting == "defaults":
        assert want == chip_smoke.PAD_PER_FWD


@pytest.mark.parametrize("setting", [n for n, _ in chip_smoke.ENGINE_TRAIN]
                         + ["remat_stages"])
def test_train_pads_are_the_steps_pad_sites(monkeypatch, setting):
    """P1's and P1''s launches per member and headline train step that
    phases 6, 8, 11, 12 and the engines phase hold the card to are those
    of one port train step (council-2) under the same settings; under
    remat_stages P1 runs again at the stages' pads."""
    from councilx_torch.config import Config
    from councilx_torch.train.trainer import CouncilTrainer

    if setting == "remat_stages":
        over = {"remat_stages": True}
        want = (chip_smoke.TRAIN_PAD_PER_MEMBER
                + chip_smoke.REMAT_PAD_PER_MEMBER,
                chip_smoke.TRAIN_FOLD_PER_MEMBER)
    else:
        over = dict(chip_smoke.ENGINE_TRAIN)[setting]
        want = chip_smoke.ENGINE_TRAIN_PADS[setting]
    raw = _narrow({**chip_smoke.HEADLINE, **over})
    raw["council"] = {**raw["council"], "council_size": 2}
    trainer = CouncilTrainer(Config.from_dict(raw), device="cpu")
    state = trainer.init_state(seed=0)
    x = torch.zeros(1, 64, 64, 3)
    calls = _count_pads(monkeypatch)
    trainer.train_step(state, x, x)
    assert calls == {"pad_nhwc": 2 * want[0], "pad_fold": 2 * want[1]}


def test_sample_sheet_pads_are_a_forward_per_member(monkeypatch):
    """Phase 8's sample sheets: ``trainer.sample`` is one forward of every
    member, ``PAD_PER_FWD`` P1 launches each and no fold."""
    from councilx_torch.config import Config
    from councilx_torch.train.trainer import CouncilTrainer

    raw = _narrow(chip_smoke.HEADLINE)
    raw["council"] = {**raw["council"], "council_size": 2}
    trainer = CouncilTrainer(Config.from_dict(raw), device="cpu")
    state = trainer.init_state(seed=0)
    calls = _count_pads(monkeypatch)
    trainer.sample(state, torch.zeros(1, 64, 64, 3))
    assert calls == {"pad_nhwc": 2 * chip_smoke.PAD_PER_FWD, "pad_fold": 0}


def test_norm_bound_is_set_by_the_bytes_not_the_arithmetic():
    for name in chip_smoke.NORM_WORK:
        ops, nbytes, kind = chip_smoke.kernel_work(name, (8, 64, 64, 256))
        assert kind == "f32"
        assert ops / chip_smoke.PEAK_OPS["f32"] < nbytes / chip_smoke.PEAK_BYTES


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    with pytest.raises(SystemExit, match="no CUDA device"):
        chip_smoke.main()


def test_time_norm_forward_refuses_to_run_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: time_norm_forward.py would run")
    monkeypatch.setattr("sys.argv", ["time_norm_forward.py"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        time_norm_forward.main()


def test_time_quant_refuses_to_run_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: time_quant.py would run")
    monkeypatch.setattr("sys.argv", ["time_quant.py", "--tiles"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        time_quant.main()


@pytest.mark.parametrize("name,label", [
    ("(anonymous namespace)::wgrad_wgmma_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float*, int*, float*, int, int)",
     "K2 wgrad (conv3x3_wgrad.cu)"),
    ("void (anonymous namespace)::instance_norm_bwd_kernel<__nv_bfloat16, "
     "8, true>(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*)",
     "K5/K6 norm backward (CUDA, instance_norm_bwd.cu)"),
    ("void (anonymous namespace)::instance_norm_fwd_kernel<__nv_bfloat16, "
     "8, true, true>(__nv_bfloat16 const*, float const*, float const*)",
     "K3/K4 norm forward (CUDA, instance_norm_fwd.cu)"),
    ("void (anonymous namespace)::conv3x3_bf16_kernel<1>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, int, int, int, int, int, int)",
     "K1/K1' conv3x3 (conv3x3.cu)"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
     "nhwc_tilesize64x256x64", "cuDNN / cuBLAS convs and matmuls"),
    ("void (anonymous namespace)::conv_int8_kernel<128, 256>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, int, "
     "float const*, float const*, void*, int, int, int, int, int, int, int, "
     "int, int)", "Q1 int8 conv (conv_int8.cu)"),
    ("void (anonymous namespace)::quant_kernel<__nv_bfloat16, true, 1>("
     "__nv_bfloat16 const*, signed char*, float const*, float*, float*, "
     "int, int, int, int, int, int, int, int, int)",
     "Q2 activation quantize (quant_act.cu)"),
    ("void (anonymous namespace)::quant_kernel<float, false, 0>(float "
     "const*, signed char*, float const*, float*, float*, int, int, int, "
     "int, int, int, int, int, int)", "Q2 activation quantize (quant_act.cu)"),
    ("void (anonymous namespace)::pad_nhwc_kernel<uint4>(uint4 const*, "
     "uint4*, int, int, int, int, long long, long long, long long, long "
     "long, int, int, int)", "P1/P1' reflect pad and fold (pad_nhwc.cu)"),
    ("void (anonymous namespace)::pad_fold_kernel<__nv_bfloat16, uint4>("
     "uint4 const*, uint4*, int, int, int, int, long long, long long, long "
     "long, long long, int, int, int)",
     "P1/P1' reflect pad and fold (pad_nhwc.cu)"),
])
def test_profile_classes_take_the_ports_kernels_before_cudnn(name, label):
    # the cuDNN class matches "conv", "wgrad" and "dgrad" substrings, so the
    # port's kernels must be claimed first
    assert profile_port.classify(name) == label


def test_chip_smoke_writes_the_train_cli_folders(tmp_path, monkeypatch):
    """Phase 8's seeded JPEG folders: four splits of CLI_IMAGES images,
    each at least the headline's new_size on its shorter side, the same
    bytes on every call."""
    from PIL import Image

    monkeypatch.setattr(chip_smoke, "CLI_IMAGES", 3)
    chip_smoke.write_folders(str(tmp_path / "a"))
    chip_smoke.write_folders(str(tmp_path / "b"))
    for split in ("trainA", "trainB", "testA", "testB"):
        names = sorted(p.name for p in (tmp_path / "a" / split).iterdir())
        assert names == ["0000.jpg", "0001.jpg", "0002.jpg"]
        for name in names:
            a = (tmp_path / "a" / split / name).read_bytes()
            assert a == (tmp_path / "b" / split / name).read_bytes()
            with Image.open(tmp_path / "a" / split / name) as img:
                assert min(img.size) >= chip_smoke.HEADLINE["new_size"]


def test_chip_smoke_times_the_decode_from_empty_queues(tmp_path, monkeypatch):
    """Phase 8's decode rate: both train loaders hand over the asked
    number of batches, and the path that decoded them is reported."""
    from councilx_torch.config import Config
    from councilx_torch.data import loader

    monkeypatch.setattr(chip_smoke, "CLI_IMAGES", 4)
    chip_smoke.write_folders(str(tmp_path))
    cfg = Config.from_dict({**chip_smoke.HEADLINE, "batch_size": 2,
                            "data_root": str(tmp_path)})
    served = []
    real_iter = loader.DataLoader.__iter__

    def counted(self):
        for batch in real_iter(self):
            served.append(batch.shape)
            yield batch

    monkeypatch.setattr(loader.DataLoader, "__iter__", counted)
    seconds, native = chip_smoke.decode_seconds(cfg, 4)
    assert seconds > 0 and isinstance(native, bool)
    assert served == [(2, 270, 270, 3)] * 8


def test_eval_launches_are_4_members_by_2_batches():
    """Phase 9's eval call: 32 images at batch 16 through council-4 is 8
    member forwards of 16 convs and 19 norm sites (8 of them AdaIN), and
    nothing under a gradient, 28 P1 launches a forward."""
    want = chip_smoke.eval_launches(chip_smoke.CLI_IMAGES,
                                    chip_smoke.EVAL_BATCH,
                                    chip_smoke.N_MEMBERS)
    assert want["conv3x3_valid.launches"] == 128
    assert want["instance_norm.launches"] == 152
    assert want["instance_norm.affine_launches"] == 64
    assert want["pad_nhwc.launches"] == 224
    assert sum(want.values()) == 128 + 152 + 64 + 224
    assert set(want) == set(chip_smoke._snapshot())
    # a padded tail batch is one more forward of every member
    assert chip_smoke.eval_launches(33, 16, 4)[
        "conv3x3_valid.launches"] == 16 * 4 * 3


def _eval_out():
    return {"fid": 1.5, "fid_per_member": [2.0, 1.5, 3.0, 2.5],
            "best_member": 1, "n_translated": 32}


@pytest.mark.parametrize("breakage", [
    None, "launches", "grad_launch", "nan_fid", "best_member", "translated",
    "members"])
def test_check_eval_raises_on_a_failed_phase_9(breakage):
    """The check passes a whole result and raises on each way phase 9 can
    fail, so the script cannot go on to exit 0 past it."""
    out = _eval_out()
    launches = chip_smoke.eval_launches(32, 16, 4)
    if breakage == "launches":
        launches["conv3x3_valid.launches"] -= 16
    elif breakage == "grad_launch":
        launches["instance_norm_backward.launches"] = 1
    elif breakage == "nan_fid":
        out["fid_per_member"][2] = float("nan")
    elif breakage == "best_member":
        out["best_member"], out["fid"] = 0, 2.0
    elif breakage == "translated":
        out["n_translated"] = 31
    elif breakage == "members":
        out["fid_per_member"] = out["fid_per_member"][:3]
    if breakage is None:
        chip_smoke.check_eval(out, launches, 32, 16, 4)
        return
    with pytest.raises(AssertionError):
        chip_smoke.check_eval(out, launches, 32, 16, 4)


def test_cuda_sources_name_every_kernel_source():
    import os

    from councilx_torch.ops import _build

    on_disk = {f[:-3] for f in os.listdir(_build.CSRC_DIR)
               if f.endswith(".cu")}
    assert set(chip_smoke.CUDA_SOURCES) == on_disk


@pytest.mark.parametrize("k,stride", [(3, 1), (4, 2), (5, 1)])
def test_unfold_int8_rows_times_the_weight_are_the_conv(k, stride):
    """Phase 3's torch._int_mm yardstick computes Q1's accumulator from
    these rows (here in int64 on the CPU against the plain conv)."""
    from councilx_torch.ops import quant as q_ops

    g = torch.Generator().manual_seed(k)
    q = torch.randint(-127, 128, (2, 11, 9, 16), generator=g,
                      dtype=torch.int8)
    w = q_ops.quantize_weights(torch.randn(k, k, 16, 24, generator=g))
    rows = chip_smoke.unfold_int8(q, k, stride)
    acc = q_ops.conv_int8_reference(q, w, torch.ones(()), None, stride,
                                    torch.int32)
    got = rows.long() @ w.w8.reshape(24, -1).t().long()
    assert torch.equal(got.view(acc.shape), acc.long())


@pytest.mark.parametrize("scope,mode,breakage", [
    ("resblocks", "w8a8", None), ("heavy", "w8a8_static", None),
    ("resblocks", "w8a8", "k1"), ("heavy", "w8a8", "per_image"),
    ("heavy", "w8a8_static", "per_image"), ("resblocks", "w8a8", "q1"),
    ("heavy", "w8a8", "q2"), ("heavy", "w8a8", "p1")])
def test_check_quant_counts_raises_on_a_wrong_launch(scope, mode, breakage):
    """Phase 10's launch check: Q1 and Q2 once each at every quantized
    conv (Q2 one launch in either mode, per image under w8a8), K1 never,
    the norms as unquantized, P1 at the unquantized convs' pads."""
    fwd = 2
    per = chip_smoke.QUANT_PER_FWD[scope] * fwd
    got = {name: 0 for name in chip_smoke._snapshot()}
    got.update({"conv_int8.launches": per, "quantize_act.launches": per,
                "quantize_act.per_image_launches": per if mode == "w8a8"
                else 0,
                "instance_norm.launches": chip_smoke.NORM_PER_FWD * fwd,
                "instance_norm.affine_launches":
                    chip_smoke.ADAIN_PER_FWD * fwd,
                "pad_nhwc.launches": chip_smoke.QUANT_PAD_PER_FWD[scope]
                * fwd})
    if breakage == "k1":
        got["conv3x3_valid.launches"] = 16
    elif breakage == "per_image":
        got["quantize_act.per_image_launches"] = 0 if mode == "w8a8" else per
    elif breakage == "q2":
        # a second launch per conv, as the two-launch per-image mode made
        got["quantize_act.launches"] *= 2
    elif breakage == "q1":
        got["conv_int8.launches"] -= 1
    elif breakage == "p1":
        # the quantized convs padded by P1 besides Q2
        got["pad_nhwc.launches"] = chip_smoke.PAD_PER_FWD * fwd
    if breakage is None:
        chip_smoke.check_quant_counts(got, fwd, scope, mode, "test")
        return
    with pytest.raises(AssertionError):
        chip_smoke.check_quant_counts(got, fwd, scope, mode, "test")


def test_quant_ragged_cases_cover_the_edges():
    """Phase 3's ragged W8A8 inputs reach every edge the kernels have:
    batch 1 with M under one 128-pixel tile, a tile over two images, both
    strides, 64- and 128-byte K steps (C 16, 64, 128, 256), 128- and
    256-channel tiles and two N tiles (O 8, 24, 128, 512)."""
    ms, straddle = [], False
    for (b, h, w, c), pad, _, k, stride, o in chip_smoke.QUANT_RAGGED:
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        ms.append((b, b * ho * wo))
        straddle |= b > 1 and any((t * 128) // (ho * wo) != (
            min(b * ho * wo, t * 128 + 127)) // (ho * wo)
            for t in range(-(-b * ho * wo // 128)))
    cases = chip_smoke.QUANT_RAGGED
    assert any(b == 1 and m < 128 for b, m in ms) and straddle
    assert {c[4] for c in cases} == {1, 2}
    assert {c[0][3] for c in cases} == {16, 64, 128, 256}
    assert {c[5] for c in cases} == {8, 24, 128, 512}


def test_write_random_vgg_gives_26_tensors_both_loaders_accept(tmp_path):
    """Phase 12 (b)'s random VGG16: the JAX package's .npz layout, 13 convs'
    kernels and biases, read by the port's loader and the JAX package's,
    the same on every call."""
    import numpy as np

    from councilx.nn.vgg import load_vgg_npz as jload
    from councilx_torch.nn import vgg

    a = chip_smoke.write_random_vgg(str(tmp_path / "a.npz"))
    b = chip_smoke.write_random_vgg(str(tmp_path / "b.npz"))
    with np.load(a) as fa, np.load(b) as fb:
        assert len(fa.files) == 26
        assert all(np.array_equal(fa[k], fb[k]) for k in fa.files)
        assert fa["conv1_1/kernel"].shape == (3, 3, 3, 64)
    port = vgg.load_vgg(a, device="cpu")
    jax_tree = jload(a)
    assert sorted(jax_tree) == sorted(name for name, _ in port.named_children())
    for name, conv in port.named_children():
        np.testing.assert_array_equal(
            conv.weight.permute(2, 3, 1, 0).numpy(),
            np.asarray(jax_tree[name]["kernel"]))


def test_remat_stage_launches_double_the_forward_counts():
    """Phase 12 (a)'s invariant over 2 headline steps: phase 6's counts
    (32 conv and 38 norm sites, 16 of them AdaIN, 122 P1 and 111 P1' per
    member and step, 4 members) with every forward counter doubled by the
    stages' recompute, P1 run again at the stages' 56 pads, and the
    backward ones unchanged."""
    steps, members = chip_smoke.MULTI_STEPS, chip_smoke.N_MEMBERS
    plain = {"conv3x3_valid.launches": 0, "conv3x3_valid.grad_launches": 0,
             "conv3x3_dgrad.launches": 0, "conv3x3_wgrad.launches": 0,
             "instance_norm.launches": 0, "instance_norm.grad_launches": 0,
             "instance_norm.affine_launches": 0,
             "instance_norm.affine_grad_launches": 0,
             "instance_norm_backward.launches": 0,
             "instance_norm_backward.affine_launches": 0,
             "conv_int8.launches": 0, "pad_nhwc.launches": 0,
             "pad_fold.launches": 0}
    conv, norm, adain, pad, fold = (n * steps * members
                                    for n in (32, 38, 16, 122, 111))
    plain.update({
        "conv3x3_valid.launches": conv, "conv3x3_valid.grad_launches": conv,
        "conv3x3_dgrad.launches": conv, "conv3x3_wgrad.launches": conv,
        "instance_norm.launches": norm, "instance_norm.grad_launches": norm,
        "instance_norm.affine_launches": adain,
        "instance_norm.affine_grad_launches": adain,
        "instance_norm_backward.launches": norm,
        "instance_norm_backward.affine_launches": adain,
        "pad_nhwc.launches": pad, "pad_fold.launches": fold})
    chip_smoke.check_train_launches(plain, steps, "plain")
    got = chip_smoke.remat_stage_launches(plain, steps)
    assert got["conv3x3_valid.launches"] == got[
        "conv3x3_valid.grad_launches"] == 2 * 256 == 512
    assert got["instance_norm.launches"] == 2 * 304
    assert got["instance_norm.affine_grad_launches"] == 2 * 128
    assert got["conv3x3_dgrad.launches"] == got["conv3x3_wgrad.launches"] \
        == 256
    assert got["instance_norm_backward.launches"] == 304
    assert got["instance_norm_backward.affine_launches"] == 128
    assert got["conv_int8.launches"] == 0
    assert got["pad_nhwc.launches"] == (122 + 56) * 8
    assert got["pad_fold.launches"] == 111 * 8
    with pytest.raises(AssertionError):
        chip_smoke.check_train_launches(got, steps, "remat_stages")


class _Engine:
    """The attributes of a BatchingEngine that engine_forwards and
    check_replays read."""

    def __init__(self, graphs, n_members=1, replays=0):
        self.graphs, self.n_members, self.replays = graphs, n_members, replays
        self.buckets = [1, 2, 4, chip_smoke.BATCH]


@pytest.mark.parametrize("graphs,members,want", [
    # captured: one eager run and one capture per bucket of (1, 2, 4, 8),
    # the 2 batches replay
    (True, 1, 8), (True, chip_smoke.N_MEMBERS, 32),
    # eager: one run per bucket at warm-up and one per batch
    (False, 1, 6), (False, chip_smoke.N_MEMBERS, 24)])
def test_engine_forwards_count_the_wrapper_calls(graphs, members, want):
    assert chip_smoke.engine_forwards(_Engine(graphs, members), 2) == want


def test_check_replays_wants_every_batch_and_bucket_replayed():
    chip_smoke.check_replays(_Engine(True, replays=4 + 2), 2, "test")
    chip_smoke.check_replays(_Engine(False), 2, "test")
    for wrong in (0, 2, 5):
        with pytest.raises(AssertionError, match="replays"):
            chip_smoke.check_replays(_Engine(True, replays=wrong), 2, "test")


def _graph_cfg(name):
    from councilx_torch.config import Config

    over, steps = {n: (o, s) for n, o, s in chip_smoke.GRAPH_TRAIN}[name]
    return Config.from_dict({**chip_smoke.HEADLINE, **over}), steps


def test_graph_train_settings_exercise_what_they_name():
    """[graphs]: the scheduled setting's council gate opens on a replay
    (after the eager warm-up call and the capture) and its weights are
    schedules; every_kth captures both of its graphs within its steps; the
    others keep the headline widths."""
    cfg, steps = _graph_cfg("scheduled")
    cc = cfg.council
    assert 2 <= cc.council_start_at_iter < steps
    assert cfg.loss_schedules.keys() == {"recon_x_w", "council_w",
                                         "mask_total_w"}
    assert 2 <= cc.focus_start_at_iter < steps and cc.focus_enabled
    cfg, steps = _graph_cfg("every_kth")
    k = cfg.council.council_dis_relative_iteration
    assert (k, cfg.council.cdis_ratio_mode) == (2, "every_kth")
    # per step shape: one eager call, one capture, then replays
    assert steps >= 3 * k
    cfg, _ = _graph_cfg("remat_stages")
    assert cfg.remat_stages
    # vgg_w: its warm-up, its capture and at least one more replay
    assert chip_smoke.GRAPH_VGG_STEPS >= 3
    for name, _, _ in chip_smoke.GRAPH_TRAIN:
        c, _ = _graph_cfg(name)
        assert (c.gen.dim, c.council.council_size, c.batch_size) == (
            64, chip_smoke.N_MEMBERS, chip_smoke.BATCH)


def test_graphs_phase_runs_after_the_engines_and_before_the_train_cli():
    import inspect

    src = inspect.getsource(chip_smoke.main)
    at = [src.index(call) for call in ("phase_engines(card_str)",
                                       "phase_graphs(card_str)",
                                       "phase_train_cli(card_str")]
    assert at == sorted(at)
    assert chip_smoke.GRAPH_WARM + chip_smoke.GRAPH_REPLAYS == 12


@pytest.mark.parametrize("spans,want", [
    ([], 0.0), ([(0, 5)], 5.0), ([(0, 5), (5, 7)], 7.0),
    # overlapping ops count once; a gap counts not at all
    ([(0, 5), (2, 4), (3, 8), (10, 11)], 9.0), ([(4, 6), (0, 5)], 6.0)])
def test_union_us_counts_overlaps_once(spans, want):
    assert chip_smoke.union_us(spans) == want


def test_phase_11_loop_samples_and_snapshots_between_replays():
    """The K=2 layout's train loop on the compiled step: step 1 is the
    eager warm-up and step 2 the capture (and its replay), so a sample
    sheet and a snapshot between two replays need a cadence step from 2 to
    LOOP_STEPS - 1; the last step's snapshot is written too."""
    between = range(2, chip_smoke.LOOP_STEPS)
    for key in ("image_save_iter", "image_display_iter",
                "snapshot_save_iter"):
        assert any(s % chip_smoke.LOOP_CADENCE[key] == 0 for s in between)
    assert chip_smoke.LOOP_STEPS % chip_smoke.LOOP_CADENCE[
        "snapshot_save_iter"] == 0
