"""Build the CUDA sources of ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` (the hash is of
the source, every ``csrc/*.cuh`` header and the flags, so an edited source
or header never loads a stale library).
Nothing is built at import: a wrapper builds its library at its first CUDA
call, and :func:`build_all` builds every source at once, one ``nvcc`` per
source, all started together (each one's seconds in :data:`BUILD_SECONDS`).
:func:`launch` calls a library's entry point on the current stream of a
tensor's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("conv3x3_packed", "conv3x3_wgmma", "conv3x3_wgrad", "conv3x3_wgrad_wgmma", "layout",
           "norm_act", "packed_norm_act", "probe", "scalar_maps")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_SECONDS: Dict[str, float] = {}  # wall seconds of each library's last nvcc
# The raw handle of a device's current stream, and the current device:
# PyTorch's private accessors, which build no Stream object and run no lazy
# init check (the public torch.cuda.current_stream(i).cuda_stream and
# torch.cuda.current_device() give the same; scripts/torch_port_launch_cost.py
# times both). Looked up here, called only with a CUDA tensor in hand.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or (
    lambda: torch.cuda.current_device())


def launch(fn: Callable[..., int], t: torch.Tensor, *args) -> int:
    """``fn(*args, stream)`` with ``stream`` the raw handle of the current
    stream on CUDA tensor ``t``'s device; returns ``fn``'s code. A kernel
    launches on the current device, so the call switches to ``t``'s device
    only where that is not the current one, and back after."""
    index = t.get_device()
    if index == _current_device():
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.cmd, proc.name = tmp, out, cmd, name
    proc.t0, proc.log = time.perf_counter(), ""
    return proc


def _wait(proc: subprocess.Popen) -> None:
    proc.log, _ = proc.communicate()
    BUILD_SECONDS[proc.name] = time.perf_counter() - proc.t0


def _finish(proc: subprocess.Popen) -> None:
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(proc.cmd)}\n{proc.log}")
    os.replace(proc.tmp, proc.out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _LOCK:
        procs = [_start(n) for n in names if not _target(n).exists()]
        try:
            # one waiting thread per nvcc, so that each one's time is its own
            waiters = [threading.Thread(target=_wait, args=(p,)) for p in procs]
            for w in waiters:
                w.start()
            for w in waiters:
                w.join()
            for p in procs:
                _finish(p)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not _target(name).exists():
        build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch: {msg}")
