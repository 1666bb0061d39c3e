"""Shared fixtures of the benchmark's tests: the cells' files at a tiny
size, and a CUDA device for the tests marked ``gpu``."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import spec

TINY_MODEL = dict(features=[4, 8, 8, 8, 8, 4], disc_features=[4, 8, 8, 8])
TINY_TRAFFIC = dict(patch=16, batch=4, pool_batches=4, trace_items=2)
TINY_SERVE = dict(volume=[24, 32, 32], pool_volumes=4, volumes_per_request=2, check_from=4,
                  check_requests=2, warmup_requests=1)


@pytest.fixture(scope="session")
def bench():
    return spec.load_benchmark()


@pytest.fixture
def tiny(bench):
    """``tiny(workload, dtype, packed)``: the cell's configuration and
    traffic cut to a size the CPU runs in seconds (the U-Net four levels
    deep on 16³ patches, a discriminator of four stride-2 blocks)."""
    return lambda workload, dtype="float32", packed=None: _tiny(bench, workload, dtype, packed)


def _tiny(bench: dict, workload: str, dtype: str, packed):
    cell = spec.cell(bench, workload)
    cfg = copy.deepcopy(spec.config(bench, cell["config"]))
    traffic = copy.deepcopy(spec.traffic(cell["traffic"]))
    cfg.update(TINY_MODEL, compute_dtype=dtype, packed=packed)
    traffic.update(TINY_TRAFFIC)
    if traffic["kind"] == "serve_cohort":
        traffic.update(TINY_SERVE)
    return cell, cfg, traffic


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
