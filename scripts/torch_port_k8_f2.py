#!/usr/bin/env python3
"""F2, reproduced: K8 (``csrc/scalar_maps.cu``) as it was while its voxels
per thread were a ``constexpr VPT`` set apart from the launch plan's ``vpt``.

  python scripts/torch_port_k8_f2.py --root DIR

``DIR`` is a checkout whose ``unet_bssfp_tpu_torch/csrc/scalar_maps.cu``
still has ``constexpr int VPT = 1;`` (e.g. the ``git archive`` of the commit
before VPT became a template parameter, unpacked under ``perf_out/``). That
source is built with VPT 1, 2 and 4, and once more at VPT 1 without its
entry point's grid check; each build is launched with the grids that plan
vpt 1, 2 and 4 give, into NaN-filled outputs, at (96, 128, 128) and at V
not a multiple of 256 ((5, 7, 3), (97, 33, 3)). One JSON line per launch:
the launch's return code, whether the maps are within
``compare_scalar_maps``' bound of the plain version, how many outputs stay
unwritten (NaN), and whether they equal this checkout's K8 (one voxel a
thread) bit for bit; first, each build's registers (``ptxas -v``); last,
the device time (profiler) of each checked build on its own plan's grid at
(96, 128, 128), beside this checkout's K8, in two passes. Needs a card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = (((96, 128, 128), 0), ((5, 7, 3), 1), ((97, 33, 3), 2))
# the grid check of the entry point before the template, and what replaces it
CHECK = "|| blocks * THREADS * VPT < V"


def build(src: str, vpt: int, check: bool, out_dir: Path, nvcc: str,
          nvcc_flags) -> ctypes.CDLL:
    text = src.replace("constexpr int VPT = 1;", f"constexpr int VPT = {vpt};")
    if not check:
        text = text.replace(CHECK, "")
    name = f"k8_vpt{vpt}{'' if check else '_nocheck'}"
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(text)
    r = subprocess.run([nvcc, *nvcc_flags, "-Xptxas", "-v", "-o", str(so), str(cu)],
                       capture_output=True, text=True, check=True)
    print(json.dumps({"build": name, "ptxas": [line.strip() for line in r.stderr.splitlines()
                                               if "registers" in line]}), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.scalar_maps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    lib.scalar_maps.restype = ctypes.c_int
    return lib


def grid(nvox: int, vpt: int, threads: int) -> int:
    """The blocks the old launch plan gave ``vpt`` voxels a thread."""
    return -(-nvox // (threads * vpt))


def launcher(torch, lib, d6, planes, rgb, blocks):
    return lambda: lib.scalar_maps(d6.data_ptr(), planes.data_ptr(), rgb.data_ptr(),
                                   d6.numel() // 6, blocks,
                                   torch.cuda.current_stream().cuda_stream)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from scripts.torch_port_norm_maps_times import device_ms
    from unet_bssfp_tpu_torch.ops import scalar_maps_check as chk
    from unet_bssfp_tpu_torch.ops.kernels import _build

    sm = importlib.import_module("unet_bssfp_tpu_torch.ops.kernels.scalar_maps")
    src = (Path(args.root) / "unet_bssfp_tpu_torch" / "csrc" / "scalar_maps.cu").read_text()
    if "constexpr int VPT = 1;" not in src or CHECK not in src:
        print(f"{args.root}: not the source with a constexpr VPT", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        nvcc = (Path(tmp), _build._nvcc(), _build.NVCC_FLAGS)
        libs = {(vpt, True): build(src, vpt, True, *nvcc) for vpt in (1, 2, 4)}
        libs[(1, False)] = build(src, 1, False, *nvcc)
        for shape, seed in SHAPES:
            d6 = torch.from_numpy(chk.sample_dt_volume(shape, seed)).to("cuda").contiguous()
            nvox = d6.numel() // 6
            ref = sm.scalar_maps_plain(d6)
            now = sm.scalar_maps(d6)
            for (vpt, check), lib in libs.items():
                for plan_vpt in (1, 2, 4):
                    planes = torch.full((6, nvox), float("nan"), device="cuda")
                    rgb = torch.full((nvox, 3), float("nan"), device="cuda")
                    rc = launcher(torch, lib, d6, planes, rgb,
                                  grid(nvox, plan_vpt, sm.THREADS))()
                    torch.cuda.synchronize()
                    row = {"shape": list(shape), "built_vpt": vpt, "grid_check": check,
                           "plan_vpt": plan_vpt, "rc": rc}
                    if rc == 0:
                        got = planes.view((6,) + shape).unbind(0) + (rgb.view(shape + (3,)),)
                        row.update(within_bound=chk.compare_scalar_maps(got, ref, d6)["ok"],
                                   unwritten=int(torch.isnan(planes[0]).sum()), voxels=nvox,
                                   equal_to_this_checkout=all(
                                       torch.equal(a, b) for a, b in zip(got, now)))
                    print(json.dumps(row), flush=True)
        d6 = torch.from_numpy(chk.sample_dt_volume(SHAPES[0][0], 0)).to("cuda").contiguous()
        nvox = d6.numel() // 6
        planes = torch.empty((6, nvox), device="cuda")
        rgb = torch.empty((nvox, 3), device="cuda")
        for run in (1, 2):
            for vpt in (1, 2, 4):
                ms, _ = device_ms(torch, launcher(torch, libs[(vpt, True)], d6, planes, rgb,
                                                  grid(nvox, vpt, sm.THREADS)))
                print(json.dumps({"timing_run": run, "shape": list(SHAPES[0][0]),
                                  "built_vpt": vpt, "device_ms": ms}), flush=True)
            ms, _ = device_ms(torch, lambda: sm.scalar_maps(d6))
            print(json.dumps({"timing_run": run, "shape": list(SHAPES[0][0]),
                              "this_checkout": True, "device_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
