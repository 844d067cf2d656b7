"""chip_smoke.py's bound arithmetic, and its refusal (and
time_norm_forward.py's) to run without a card; profile_port.py's classes
of kernel names.

chip_smoke imports only torch, numpy and councilx_torch. The least time it
prints beside each kernel's measured time is computed from shapes alone,
so it is held here against values worked out by hand: bf16 at the main
path's shapes, each input read once and each output written once, against
989 TFLOP/s (tensor cores) and 3.35 TB/s.
"""

import pytest
import torch

import chip_smoke
import profile_port
import time_norm_forward

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
