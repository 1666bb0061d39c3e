#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unet_bssfp_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases (any failure → nonzero exit, no ``ok`` line):
1. The card's name and power limit; build of every kernel from the
   repository's sources (``nvcc`` for ``csrc/*.cu``, Triton JIT for the norm).
2. Kernel checks: each kernel against its plain PyTorch version at the
   serving path's shapes, f32 and bf16, with its time, its bound (bytes over
   3.35 TB/s or operations over the peak of their type), the plain version's
   time and one PyTorch library call's time.
3. Main path: the full-width pc-bSSFP generator with seeded random weights
   serves one (96, 128, 128, 24) volume through ``predict_volume``,
   patch-stitched (8 × 64³) and whole-volume, with ``use_pallas`` off and
   on; launch counts of every kernel in that run; ms per volume; the f32
   output of the packed kernel path against the same model on plain
   PyTorch/cuDNN, and the bf16 output's error against f32.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``kernels`` JSON; details go to
``perf_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,           # dense tensor-core bf16
            "float32": 67e12}             # f32 outside the tensor cores
VOLUME = (96, 128, 128)
MODALITY = "pc-bssfp"
SEED = 0


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int) -> float:
    """CUDA-event time per call over ``iters`` calls, after two warm-ups."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Checks:
    def __init__(self):
        self.failures = []
        self.rows = []

    def record(self, ok: bool, row: dict):
        row["ok"] = bool(ok)
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        if not ok:
            self.failures.append(row)


def phase_build(torch, K, _build):
    t0 = time.perf_counter()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    _build.build_all()
    nvcc_s = time.perf_counter() - t0
    x = torch.randn(1, 2, 2, 2, 8, device="cuda")
    K.fused_instance_norm_leaky_relu(x, torch.ones(8, device="cuda"),
                                     torch.zeros(8, device="cuda"))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"build: nvcc {nvcc_s:.1f}s (csrc/*.cu in parallel), "
          f"with Triton JIT {total:.1f}s", flush=True)
    return {"nvcc_s": nvcc_s, "total_s": total}


def check_conv(torch, F, K, checks, b, d, h, w, cin, cout, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(cin * 1000 + d)
    xk = torch.randn(b, d, cin, h * w, device="cuda", generator=g).to(dt)
    wt = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=g) / (27 * cin) ** 0.5
    bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    got = K.conv3x3_packed(xk, wt, bias, w).float()
    ref = K.conv3x3_packed_plain(xk, wt, bias, w).float()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    # f32: the two differ only in summation order over 27·Cin ≤ 2592 terms;
    # bf16: both round the f32 sum once, so they may land one bf16 ulp
    # (2^-7 relative) apart.
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    atol = 1e-4 * scale
    ok = bool((err <= atol + rtol * ref.abs()).all())
    xn = xk.reshape(b, d, cin, h, w).permute(0, 2, 1, 3, 4)
    wl = wt.to(dt).permute(4, 3, 0, 1, 2).contiguous()
    bl = bias.to(dt)
    iters = 5 if b * d * h * w >= 1 << 20 else 20
    ms = time_ms(torch, lambda: K.conv3x3_packed(xk, wt, bias, w), iters)
    plain_ms = time_ms(torch, lambda: K.conv3x3_packed_plain(xk, wt, bias, w), iters)
    lib_ms = time_ms(torch, lambda: F.conv3d(xn, wl, bl, padding=1), iters)
    nbytes = (xk.numel() * xk.element_size() + wt.numel() * 4 + cout * 4
              + b * d * cout * h * w * xk.element_size())
    bms, by = bound(nbytes, 2 * 27 * cin * cout * b * d * h * w, dtype)
    checks.record(ok, dict(
        kernel="conv3x3_packed", shape=[b, d, cin, h * w], cout=cout,
        dtype=dtype, max_abs_err=float(err.max()), ref_max_abs=scale,
        rtol=rtol, atol=atol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms))


def check_layout(torch, K, checks, b, d, h, w, c, dtype, direction):
    dt = getattr(torch, dtype)
    if direction == "pack":
        x = torch.randn(b, d, h, w, c, device="cuda").to(dt)
        kern, plain = (lambda: K.pack_hw(x)), (lambda: K.pack_hw_plain(x))
        lib = lambda: x.permute(0, 1, 4, 2, 3).contiguous()  # noqa: E731
        name = "pack_hw"
    else:
        x = torch.randn(b, d, c, h * w, device="cuda").to(dt)
        kern, plain = (lambda: K.unpack_hw(x, w)), (lambda: K.unpack_hw_plain(x, w))
        lib = lambda: x.reshape(b, d, c, h, w).permute(0, 1, 3, 4, 2).contiguous()  # noqa: E731
        name = "unpack_hw"
    got, ref = kern(), plain()
    ok = torch.equal(got, ref)  # a permutation: exact
    iters = 10
    nbytes = 2 * x.numel() * x.element_size()
    bms, by = bound(nbytes, 0, dtype)
    checks.record(ok, dict(
        kernel=name, shape=list(x.shape), dtype=dtype,
        max_abs_err=float((got.float() - ref.float()).abs().max()),
        rtol=0.0, atol=0.0, ms=time_ms(torch, kern, iters),
        plain_ms=time_ms(torch, plain, iters), bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lib, iters)))


def check_norm(torch, F, K, checks, shape, dtype):
    dt = getattr(torch, dtype)
    c = shape[-1]
    g = torch.Generator(device="cuda").manual_seed(c)
    x = torch.randn(shape, device="cuda", generator=g).to(dt)
    s = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bb = 0.1 * torch.randn(c, device="cuda", generator=g)
    got = K.fused_instance_norm_leaky_relu(x, s, bb, 0.1).float()
    ref = K.instance_norm_leaky_relu_plain(x, s, bb, 0.1).float()
    err = (got - ref).abs()
    # f32: moments summed in another order over ≤ 196608 voxels; bf16: the
    # output rounds once, so the two may land one bf16 ulp apart.
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else (2 ** -7, 1e-2)
    ok = bool((err <= atol + rtol * ref.abs()).all())
    xn = x.permute(0, 4, 1, 2, 3)
    sl, bl = s.to(dt), bb.to(dt)
    iters = 10
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    bms, by = bound(nbytes, 9 * x.numel(), "float32")
    checks.record(ok, dict(
        kernel="fused_instance_norm_leaky_relu", shape=list(shape),
        dtype=dtype, max_abs_err=float(err.max()), rtol=rtol, atol=atol,
        ms=time_ms(torch, lambda: K.fused_instance_norm_leaky_relu(x, s, bb, 0.1), iters),
        plain_ms=time_ms(torch, lambda: K.instance_norm_leaky_relu_plain(x, s, bb, 0.1), iters),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.leaky_relu(
            F.instance_norm(xn, weight=sl, bias=bl, eps=1e-5), 0.1), iters)))


def phase_kernels(torch, F, K, checks):
    patch = (8, 64, 64, 64)          # 8 patches of 64³ per batch
    whole = (1,) + VOLUME
    for dtype in ("bfloat16", "float32"):
        for b, d, h, w in (patch, whole):
            for cin in (24, 32, 96):  # conv_0.conv_0, *.conv_1, upcat_1.conv_0
                check_conv(torch, F, K, checks, b, d, h, w, cin, 32, dtype)
            check_layout(torch, K, checks, b, d, h, w, 24, dtype, "pack")   # head → conv_0
            check_layout(torch, K, checks, b, d, h, w, 64, dtype, "pack")   # upcat_1 upsample
            check_layout(torch, K, checks, b, d, h, w, 6, dtype, "unpack")  # final conv
        # The plain-layer stages: down_1 … down_4 (and their upcats) at
        # patch (B 8) and whole-volume (B 1) sizes.
        for n, base in ((8, (32, 32, 32)), (1, (48, 64, 64))):
            for level, c in enumerate((64, 128, 256, 512)):
                sp = tuple(s >> level for s in base)
                check_norm(torch, F, K, checks, (n,) + sp + (c,), dtype)


def run_volume(torch, predict_volume, fn, vol, whole):
    out = predict_volume(fn, vol, patch_size=64, whole_volume=whole)
    torch.cuda.synchronize()
    return out


def phase_main_path(torch, K, checks, pkg):
    Config, build_models, make_predict_fn, weights, predict_volume = pkg
    cfg = Config()
    mcfg = cfg.model
    if tuple(cfg.data.volume_shape) != VOLUME or cfg.data.patch_size != 64:
        raise RuntimeError(f"default config serves {cfg.data.volume_shape} / "
                           f"{cfg.data.patch_size}, not {VOLUME} / 64")
    device = torch.device("cuda")
    probe = build_models(MODALITY, mcfg, device)
    sd = weights.random_state_dict(probe, SEED)
    del probe

    def model(**over):
        gen = build_models(MODALITY, dataclasses.replace(mcfg, **over),
                           device, state_dict=sd)
        return make_predict_fn(gen)

    g = torch.Generator().manual_seed(SEED)
    vol = torch.randn(VOLUME + (24,), generator=g).to(device)
    runs = {}
    for use_pallas in (False, True):
        fn = model(use_pallas=use_pallas)
        for whole in (False, True):
            runs[(whole, use_pallas)] = fn
    for (whole, _), fn in runs.items():           # warm-up (Triton JIT, cuDNN)
        run_volume(torch, predict_volume, fn, vol, whole)

    K.reset_launches()
    outs = {key: run_volume(torch, predict_volume, fn, vol, key[0])
            for key, fn in runs.items()}
    counts = K.launches()
    print("main-path launches: " + json.dumps(counts), flush=True)
    checks.record(all(v > 0 for v in counts.values()),
                  dict(phase="main_path_launches", launches=counts))

    timing = {}
    for (whole, use_pallas), fn in runs.items():
        ts = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(5):
            t0 = time.perf_counter()
            run_volume(torch, predict_volume, fn, vol, whole)
            ts.append((time.perf_counter() - t0) * 1e3)
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        key = f"{'whole' if whole else 'patch'}_use_pallas_{use_pallas}"
        timing[key] = {"ms_per_volume_median": statistics.median(ts),
                       "ms_all": ts, "peak_mib": peak_mib}
        print(f"ms/volume {key} (bf16): {statistics.median(ts):.3f} "
              f"(runs {', '.join(f'{t:.3f}' for t in ts)}); peak "
              f"{peak_mib:.0f} MiB allocated", flush=True)
    del runs

    # f32: packed kernel path (K1, K3, K4) vs the same weights on plain
    # PyTorch/cuDNN (TF32 off). Tolerance 1e-3 of max|ref|: f32 summation
    # order differs in every conv and norm, compounded over 23 conv layers.
    f32_kern = model(compute_dtype="float32", packed=True, use_pallas=True)
    f32_plain = model(compute_dtype="float32", packed=False, use_pallas=False)
    for whole in (False, True):
        got = run_volume(torch, predict_volume, f32_kern, vol, whole).float()
        ref = run_volume(torch, predict_volume, f32_plain, vol, whole).float()
        rel = float((got - ref).abs().max() / ref.abs().max())
        mode = "whole" if whole else "patch"
        checks.record(rel <= 1e-3 and bool(torch.isfinite(got).all())
                      and tuple(got.shape) == VOLUME + (6,),
                      dict(phase="main_path_f32_vs_plain", mode=mode,
                           rel_max_err=rel, tol=1e-3))
        for use_pallas in (False, True):
            out = outs[(whole, use_pallas)].float()
            rel_bf16 = float((out - ref).abs().max() / ref.abs().max())
            # bf16 vs f32 is reported; the 0.1 bound only catches a layout
            # or indexing fault, which gives errors of order 1.
            checks.record(bool(torch.isfinite(out).all()) and rel_bf16 < 0.1
                          and tuple(out.shape) == VOLUME + (6,),
                          dict(phase="main_path_bf16_vs_f32", mode=mode,
                               use_pallas=use_pallas, rel_max_err=rel_bf16))
    return counts, timing


KERNEL_META = {
    "conv3x3_packed": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_packed.cu",
                       "unet_bssfp_tpu/ops/pallas/conv3d.py:388"),
    "pack_hw": ("cuda", "unet_bssfp_tpu_torch/csrc/layout.cu",
                "unet_bssfp_tpu/ops/pallas/conv3d.py:1259"),
    "unpack_hw": ("cuda", "unet_bssfp_tpu_torch/csrc/layout.cu",
                  "unet_bssfp_tpu/ops/pallas/conv3d.py:1287"),
    "fused_instance_norm_leaky_relu": (
        "triton", "unet_bssfp_tpu_torch/ops/kernels/norm_act.py",
        "unet_bssfp_tpu/ops/pallas/fused_norm_act.py:150"),
}
# The row of each kernel in the summary line: its heaviest bf16 shape on
# the patch-stitched main path.
SUMMARY_SHAPE = {
    "conv3x3_packed": [8, 64, 96, 4096],
    "pack_hw": [8, 64, 64, 64, 64],
    "unpack_hw": [8, 64, 6, 4096],
    "fused_instance_norm_leaky_relu": [8, 32, 32, 32, 64],
}


def summary(rows, counts):
    out = []
    for name, (route, source, replaces) in KERNEL_META.items():
        row = next(r for r in rows if r.get("kernel") == name
                   and r["dtype"] == "bfloat16" and r["shape"] == SUMMARY_SHAPE[name])
        out.append({"name": name, "route": route, "source": source,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "shape": row["shape"], "dtype": row["dtype"]})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.ops import kernels as K
    from unet_bssfp_tpu_torch.ops.kernels import _build
    from unet_bssfp_tpu_torch.train.state import build_models
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    checks = Checks()
    build = phase_build(torch, K, _build)
    phase_kernels(torch, F, K, checks)
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f}s", flush=True)
    counts, timing = phase_main_path(
        torch, K, checks,
        (Config, build_models, make_predict_fn, weights, predict_volume))
    elapsed = time.perf_counter() - t_start

    kernels = summary(checks.rows, counts)
    os.makedirs("perf_out", exist_ok=True)
    with open(os.path.join("perf_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build": build,
                   "checks": checks.rows, "main_path_launches": counts,
                   "timing": timing, "kernels": kernels,
                   "elapsed_s": elapsed}, f, indent=1)
    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed:", file=sys.stderr)
        for row in checks.failures:
            print(json.dumps(row), file=sys.stderr)
        return 1
    print(f"elapsed {elapsed:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
