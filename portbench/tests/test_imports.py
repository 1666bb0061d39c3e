"""Nothing the harness runs loads JAX or the JAX package: a fresh process
imports every module of ``portbench`` and drives a tiny cell end to end,
then lists the top-level names in ``sys.modules`` (compared whole)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, pkgutil, importlib, sys, time
import portbench
from portbench import spec
from portbench.run import forbidden_modules, run_cell
from portbench.tests.conftest import _tiny
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
bench = spec.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
for w in ("gan-train-b16", "gan-serve-cohort-b32"):
    cell, cfg, traffic = _tiny(bench, w, "float32", None)
    run_cell(bench, cell, 1, 0.1, True, "cpu", time.perf_counter(), cfg=cfg, traffic=traffic)
top = {m.split(".")[0] for m in sys.modules}
print(json.dumps({"forbidden": forbidden_modules(), "port": "unet_bssfp_tpu_torch" in top}))
"""


def test_no_jax_in_the_harness():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


def test_forbidden_names_are_compared_whole():
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["unet_bssfp_tpu_torch_like"] = sys.modules["json"]
        sys.modules["jax_free.sub"] = sys.modules["json"]
        assert run.forbidden_modules() == [m for m in ("jax", "jaxlib", "flax", "unet_bssfp_tpu")
                                           if m in {k.split(".")[0] for k in saved}]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
