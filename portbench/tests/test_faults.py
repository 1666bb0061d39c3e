"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a CUDA device and drives the rest
of a run (set-up, window, check against the cell's own limits) at a tiny
size on the CPU in float32: once sound, where ``correct`` is true, and
once for each fault the cell can have: a step that leaves the state
unchanged, half of the batch left out (the mean over the rest), an answer
altered where it is produced. The cells run on one device: no exchange
between devices to leave out."""

from __future__ import annotations

import time

import pytest

from portbench.run import run_cell

CASES = [("gan-train-b16", f) for f in (None, "unchanged", "half")] + \
        [("multistage-finetune-b8", f) for f in (None, "unchanged", "half")] + \
        [("multistage-transfer-b8", f) for f in (None, "unchanged", "half")] + \
        [("gan-serve-cohort-b32", f) for f in (None, "half", "altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(bench, tiny, workload, fault):
    cell, cfg, traffic = tiny(workload)
    out = run_cell(bench, cell, 20260101, 0.2, False, "cpu", time.perf_counter(),
                   fault=fault, cfg=cfg, traffic=traffic)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert all({"value", "limit"} == set(v) for v in out["checks"].values())
