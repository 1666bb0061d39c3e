#!/usr/bin/env python3
"""Registers, spills and static shared memory of every kernel instance in
the port's CUDA libraries, as ``ptxas -v`` reports them.

  python scripts/torch_port_ptxas.py [--root DIR] [--sass] [conv3x3_wgmma probe ...]

Compiles each named ``csrc/<name>.cu`` (default: all of
``_build.SOURCES``; ``--root``: another checkout's, the parent's for a
comparison) with the build's own flags plus ``-Xptxas -v`` into a
scratch library under ``_build/`` (deleted after) and prints one JSON line
per kernel instance: its demangled name (``cu++filt`` where the toolkit has
it), registers, spill stores and loads in bytes, and static shared memory.
With ``--sass``, each line also counts the instance's SASS instructions by
opcode (``cuobjdump -sass``): all of them, MUFU (and by function), FFMA,
FMUL, FADD, BRA. These are static counts of the code as laid out, slow
paths included (a division's fix-up branch is counted, not weighed by how
often it runs). Needs ``nvcc``: run it on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unet_bssfp_tpu_torch.ops.kernels import _build  # noqa: E402


def sass_counts(lib: Path) -> dict:
    """{mangled kernel name: {opcode class: count}} from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), {"total": 0, "MUFU": 0, "FFMA": 0,
                                                     "FMUL": 0, "FADD": 0, "BRA": 0})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m is None or current is None:
            continue
        op = m.group(1)
        current["total"] += 1
        base = op.split(".")[0]
        if base in current:
            current[base] += 1
        if base == "MUFU":
            current[op] = current.get(op, 0) + 1
    return counts


def report(name: str, csrc: Path, sass: bool = False) -> list:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"ptxas-{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
           str(csrc / f"{name}.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    counts = sass_counts(out) if sass else {}
    out.unlink(missing_ok=True)
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = {"library": name, "mangled": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(s.group(1)) if s else 0
            if sass:
                current["sass"] = counts.get(current["mangled"])
            rows.append(current)
            current = None
    filt = shutil.which("cu++filt") or (
        "/usr/local/cuda/bin/cu++filt" if os.path.exists("/usr/local/cuda/bin/cu++filt")
        else None)
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r["mangled"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", help="a checkout whose csrc/ to compile")
    parser.add_argument("--sass", action="store_true",
                        help="count each instance's SASS instructions by opcode")
    parser.add_argument("names", nargs="*", default=list(_build.SOURCES))
    args = parser.parse_args()
    csrc = (Path(args.root).resolve() / "unet_bssfp_tpu_torch" / "csrc" if args.root
            else _build.CSRC)
    for name in args.names:
        for row in report(name, csrc, args.sass):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
