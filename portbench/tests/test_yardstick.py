"""The benchmark's yardstick: its FLOP counts against the program's
``utils/flops.py``, and each metric's arithmetic on a small synthetic
profiler trace and window."""

from __future__ import annotations

import pytest

from portbench import flops, spec, trace
from unet_bssfp_tpu_torch.utils import flops as program_flops

GAN = dict(in_ch=24, out_ch=6, unet_in=24, features=(32, 64, 128, 256, 512, 32))
THESIS = (48, 96, 192, 384, 768, 24)


def test_gan_step_is_the_programs_count():
    got = flops.gan_step(8, 64, 24, 6, 24, GAN["features"], (32, 64, 128, 256, 512))
    assert got == pytest.approx(program_flops.gan_step_flops(batch=8), rel=1e-12)
    assert got == pytest.approx(4.939e12, rel=1e-3)
    assert flops.total(flops.generator_convs(64, **GAN)) == pytest.approx(
        program_flops.generator_fwd_flops(), rel=1e-12)


def test_transfer_takes_no_unet_weight_gradient():
    head = flops.total(flops.head_convs(64, 24, 24))
    unet = flops.total(flops.unet_convs(64, 24, 6, THESIS))
    transfer = flops.supervised_step("transfer", 8, 64, 24, 6, 24, THESIS)
    finetune = flops.supervised_step("finetune", 8, 64, 24, 6, 24, THESIS)
    # forward of both, the U-Net's dx only, the head's dx and dw
    assert transfer == pytest.approx(8 * (head * 3 + unet * 2))
    assert finetune - transfer == pytest.approx(8 * unet)


def test_serve_chunk_and_conv_share():
    chunk = flops.serve_chunk(32, 64, 24, 6, 24, GAN["features"])
    assert chunk == pytest.approx(32 * program_flops.generator_fwd_flops())
    conv3 = flops.serve_chunk(32, 64, 24, 6, 24, GAN["features"], only_kernels=(3, 4))
    convs = flops.generator_convs(64, **GAN)
    others = sum(f for k, f in convs if k in (0, 1))
    assert chunk - conv3 == pytest.approx(32 * others)
    assert 0.9 < conv3 / chunk < 1.0


def _events():
    """A window of 10 ms (two items) with three kernels: a packed conv
    [1, 3] ms, an elementwise kernel [2, 4] ms (overlapping it), a cuDNN
    conv [6, 9] ms; a step span on the host over [0, 5] and a sync over
    [5, 10]."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts * 1e3, "dur": dur * 1e3}
    return [
        x("user_annotation", "portbench.window", 0, 10),
        x("user_annotation", "portbench.step", 0, 5),
        x("user_annotation", "portbench.sync", 5, 5),
        x("kernel", "void conv3x3_wgmma_kernel<32>", 1, 2),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 2, 2),
        x("kernel", "sm90_xmma_fprop_implicit_gemm", 6, 3),
        x("cpu_op", "aten::add", 0, 1),
        x("kernel", "outside the window", 11, 1),
    ]


def test_summary_of_a_synthetic_trace():
    s = trace.summarise(_events(), items=2)
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.006)  # [1, 4] and [6, 9]
    assert s["ops"] == 3
    assert s["group_s"]["ATen elementwise"] == pytest.approx(0.002)
    assert s["group_s"]["cuDNN/cuBLAS convs and GEMMs"] == pytest.approx(0.003)
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert s["idle_gaps"][0][1] == pytest.approx(0.002)  # [4, 6]: the step span's
    assert {round(v, 6) for _, v in s["idle_gaps"]} == {0.001, 0.002}
    assert set(gaps) == {"step", "sync"}
    assert trace.summarise([e for e in _events() if e["cat"] != "kernel"], 2) is None


def _ctx(kind="train"):
    return {"kind": kind, "units_per_item": 8, "items": 100, "elapsed_s": 10.0,
            "item_s": [0.1] * 94 + [0.2] * 6, "host_s": [0.03] * 100, "setup_s": 12.5,
            "peak_bytes": 3 * 2 ** 30, "trace": trace.summarise(_events(), items=2),
            "model_flops": 4.0e12, "conv_flops": 9.89e9, "peak_flops": 989e12}


@pytest.mark.parametrize("name,kind,want", [
    ("train_patches_per_s", "train", 80.0),
    ("serve_volumes_per_s", "serve", 80.0),
    ("serve_chunk_ms_p95", "serve", 200.0),
    ("peak_mem_gib", "train", 3.0),
    ("setup_s", "serve", 12.5),
    ("host_ms.train", "train", 30.0),
    ("device_ops.serve", "serve", 1.5),
    # elementwise 2 ms over 2 items
    ("eager_ms.train", "train", 1.0),
    # 9.89 GFLOP at 989 TFLOP/s = 10 us, over 2.5 ms of conv groups an item
    ("conv_roofline.train", "train", 0.4),
    # 10 items a second of 4 TFLOP, over 989 TFLOP/s
    ("mfu.serve", "serve", 100.0 * 40e12 / 989e12),
    # 3 ms busy an item traced, over 100 ms an item in the window
    ("idle_share.train", "train", 97.0),
])
def test_reader_arithmetic(name, kind, want):
    assert spec.reader(name).read(_ctx(kind)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["train_patches_per_s", "host_ms.train", "mfu.train",
                                  "idle_share.train", "conv_roofline.train"])
def test_readers_find_nothing_elsewhere(name):
    ctx = _ctx("serve")
    assert spec.reader(name).read(ctx) is None
    ctx = _ctx("train")
    ctx.update(trace=None, peak_flops=None)
    if name not in ("train_patches_per_s", "host_ms.train"):
        assert spec.reader(name).read(ctx) is None
