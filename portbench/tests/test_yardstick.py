"""The benchmark's yardstick: its FLOP counts against the program's
``utils/flops.py``, K10's byte count, the kernel groups, and each metric's
arithmetic on a small synthetic profiler trace and window."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import flops, readers, spec, trace
from portbench.drivers import gan_train, serve_cohort, supervised_train
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


def test_norm_act_bytes_of_each_cell():
    """K10's least bytes an item: the four packed blocks' elements times the
    bytes an element of each pass (bf16, dropout on)."""
    assert [flops.norm_act_pass_bytes(k, 2, True) for k in
            ("grad", "no_grad", "backward", "eval")] == [9, 8, 7, 4]
    assert flops.norm_act_pass_bytes("grad", 4, False) == 8
    bench = spec.load_benchmark()
    gan = spec.config(bench, "unet-gan-pcbssfp")
    thesis = spec.config(bench, "multiinput-unet-thesis")
    work = gan_train.kernel_work(gan, spec.traffic("train-b16-p64"))["norm_act"]
    assert work == {"keys": ["norm_act_kernel_packed"], "flops": 0.0,
                    "bytes": 16 * 64 ** 3 * 128 * (9 + 8 + 7)}
    for traffic in ("supervised-b8-p64-finetune", "supervised-b8-p64-transfer"):
        got = supervised_train.kernel_work(thesis, spec.traffic(traffic))["norm_act"]["bytes"]
        assert got == 8 * 64 ** 3 * (48 + 48 + 24 + 24) * (9 + 7)
    got = serve_cohort.kernel_work(gan, spec.traffic("serve-cohort-v4-p64"))["norm_act"]["bytes"]
    assert got == 32 * 64 ** 3 * 128 * 4
    assert gan_train.kernel_work(dict(gan, packed=False), spec.traffic("train-b16-p64")) == {}


def _named_events():
    """A window of 10 ms (two items): K10's stats and apply kernels [1, 2]
    and [2, 4], an SDPA kernel [4, 5], a cuDNN conv [6, 9] and a memset
    [9, 9.5]."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts * 1e3, "dur": dur * 1e3}
    return [
        x("user_annotation", "portbench.window", 0, 10),
        x("kernel", "void (anonymous namespace)::norm_act_kernel_packed_stats<bf16, 8>", 1, 1),
        x("kernel", "void (anonymous namespace)::norm_act_kernel_packed_apply<bf16, bf16, 8>",
          2, 2),
        x("kernel", "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(AttentionKernel<...>::Params)", 4, 1),
        x("kernel", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32", 6, 3),
        x("gpu_memset", "Memset (Device)", 9, 0.5),
    ]


@pytest.mark.parametrize("events", [_events, _named_events])
def test_name_s_sums_to_group_s(events):
    s = trace.summarise(events(), items=2)
    groups = {}
    for name, sec in s["name_s"].items():
        groups[trace.group_of(name)] = groups.get(trace.group_of(name), 0.0) + sec
    assert groups == pytest.approx(s["group_s"])
    assert len(s["name_s"]) == s["ops"]  # every name once here


@pytest.mark.parametrize("name", [
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(AttentionKernel<cutlass::bfloat16_t>::Params)",
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 128, 64, 4>>",
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_64x64x64",
    "void window_attn_kernel<bf16>"])
def test_a_kernel_named_like_sdpa_is_attention(name):
    assert trace.group_of(name) == "attention (SDPA, flash, fused MHA)"


KERNELS = Path(__file__).with_name("cell_kernels.json")


def test_the_cells_kernels_keep_their_groups():
    """Every kernel that a traced run of the four cells launched, with the
    group it had before the attention group came in."""
    recorded = json.loads(KERNELS.read_text())["groups"]
    assert len(recorded) > 50
    assert {n: trace.group_of(n) for n in recorded} == recorded


def _kctx(kind="train", **kw):
    ctx = {"kind": kind, "trace": trace.summarise(_named_events(), items=2), "cfg": {},
           "traffic": {}, "peak_flops": 989e12, "peak_bandwidth": 3.35e12,
           "work": {"norm_act": {"keys": ["norm_act_kernel_packed"], "flops": 0.0,
                                 "bytes": 3.35e9}}}
    ctx.update(kw)
    return ctx


def test_kernel_ms_and_roofline_arithmetic():
    # K10: 3 ms over 2 items; 3.35 GB at 3.35 TB/s is 1 ms of its 1.5 an item
    assert spec.reader("norm_act_ms.train").read(_kctx()) == pytest.approx(1.5)
    assert spec.reader("norm_act_roofline.train").read(_kctx()) == pytest.approx(100 / 1.5)
    assert readers.kernel_ms("train", ["fmha", "Memset"])(_kctx()) == pytest.approx(0.75)
    # a bound by FLOPs: 989 GFLOP at 989 TFLOP/s is 1 ms of the conv's 1.5 an item;
    # its bytes (0.335 ms) bound less; a work of bytes alone needs the bandwidth
    conv = {"keys": ["xmma"], "flops": 989e9, "bytes": 3.35e9 / 3}
    assert readers.kernel_roofline("train", lambda cfg, traffic: conv)(_kctx()) == \
        pytest.approx(100 / 1.5)
    conv = dict(conv, flops=0.0)
    assert readers.kernel_roofline("train", lambda cfg, traffic: conv)(_kctx()) == \
        pytest.approx(100 / 1.5 / 3)


@pytest.mark.parametrize("name,kw", [
    ("norm_act_ms.train", dict(kind="serve")),
    ("norm_act_ms.serve", {}),
    ("norm_act_ms.train", dict(trace=None)),
    ("norm_act_roofline.train", dict(kind="serve")),
    ("norm_act_roofline.train", dict(work={})),
    ("norm_act_roofline.train", dict(peak_bandwidth=None)),
    ("norm_act_roofline.train", dict(trace=trace.summarise(_events(), items=2))),
])
def test_kernel_readers_find_nothing_elsewhere(name, kw):
    assert spec.reader(name).read(_kctx(**kw)) is None


def _table():
    """Two items of a GAN step's spans: device s, ops, blocking calls an item."""
    def row(ms, blocking=0.0):
        return {"device_s": ms / 1e3, "ops": 10.0, "blocking": blocking, "host_s": 0.01}
    return {"items": 2, "device_s": 0.0105, "uncredited_s": 0.0,
            "spans": {"bssfp.step": row(0.0), "bssfp.gen.forward": row(3.0),
                      "bssfp.disc.forward": row(2.0), "bssfp.gen.loss": row(0.5),
                      "bssfp.gen.backward": row(4.0, 1.0), "bssfp.gen.optimizer": row(0.5),
                      "bssfp.disc.optimizer": row(0.0)}}


def _sctx(kind="train", **kw):
    ctx = {"kind": kind, "spans": _table(),
           "launches": {"packed_norm_act": 8.0, "packed_norm_act_backward": 4.0,
                        "conv3x3_wgrad": 0.0}}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name,want", [
    ("forward_ms.train", 5.0),
    ("loss_ms.train", 0.5),
    ("backward_ms.train", 4.0),
    ("optimizer_ms.train", 0.5),
    ("syncs.train", 1.0),
    ("span_coverage.train", 100.0 * 10.0 / 10.5),
    ("norm_act_launches.train", 12.0),
])
def test_span_and_counter_readers_arithmetic(name, want):
    assert spec.reader(name).read(_sctx()) == pytest.approx(want)


def test_serving_span_readers_arithmetic():
    table = {"items": 1, "device_s": 0.040, "uncredited_s": 0.0005,
             "spans": {"bssfp.extract": {"device_s": 0.0005, "ops": 8, "blocking": 0,
                                         "host_s": 0.001},
                       "bssfp.predict": {"device_s": 0.038, "ops": 300, "blocking": 0,
                                         "host_s": 0.01},
                       "bssfp.stitch": {"device_s": 0.001, "ops": 40, "blocking": 2,
                                        "host_s": 0.002}}}
    ctx = _sctx("serve", spans=table, launches={"packed_norm_act": 4.0,
                                                 "packed_norm_act_backward": 0.0})
    got = {n: spec.reader(n).read(ctx) for n in ("extract_ms.serve", "predict_ms.serve",
                                                   "stitch_ms.serve", "syncs.serve",
                                                   "span_coverage.serve",
                                                   "norm_act_launches.serve")}
    assert got == pytest.approx({"extract_ms.serve": 0.5, "predict_ms.serve": 38.0,
                                 "stitch_ms.serve": 1.0, "syncs.serve": 2.0,
                                 "span_coverage.serve": 100.0 * 39.5 / 40,
                                 "norm_act_launches.serve": 4.0})


@pytest.mark.parametrize("name", ["forward_ms.train", "syncs.train", "span_coverage.train",
                                  "norm_act_launches.train", "extract_ms.serve",
                                  "span_coverage.serve"])
def test_span_and_counter_readers_find_nothing_elsewhere(name):
    other = "serve" if name.endswith(".train") else "train"
    assert spec.reader(name).read(_sctx(other)) is None
    assert spec.reader(name).read(_sctx(name.rsplit(".", 1)[1], spans=None,
                                        launches=None)) is None
    empty = dict(_table(), spans={})
    assert spec.reader(name).read(_sctx(name.rsplit(".", 1)[1], spans=empty,
                                        launches={})) is None
