"""Closed loop, one client, of cohort serving: a request takes
``volumes_per_request`` resident seeded volumes, the port's sampler cuts
each into its grid of patches (``grid_patch_starts`` + ``extract_patches``),
one ``make_predict_fn`` call runs on all of them, and ``GridAggregator``
stitches each volume back. The answers of the requests that
:func:`portbench.inputs.checked_requests` draws are kept and, after the
window, compared with the reference's stitched volumes."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from portbench import check, inputs
from portbench import flops as pf
from portbench.drivers import common
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train


class ServeCohort:
    kind = "serve"
    sync_each = True  # a request's latency runs to its answers synchronised

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None):
        from unet_bssfp_tpu_torch.data.sampler import GridAggregator, grid_patch_starts
        from unet_bssfp_tpu_torch.train.state import build_models
        from unet_bssfp_tpu_torch.train.steps import make_predict_fn

        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault
        self.units_per_item = traffic["volumes_per_request"]
        self.phases = common.Phases()
        gen, _ = build_models(cfg["modality"], common.model_config(cfg), device)
        self.phases.mark("models")
        gen.load_state_dict(_weights(cfg, seed, device), strict=True)
        self.predict = make_predict_fn(gen)
        self.pool = inputs.volumes(traffic, seed, cfg["in_channels"], device)
        self.order = inputs.volume_order(traffic, seed)
        shape = tuple(traffic["volume"])
        self.starts = grid_patch_starts(shape, traffic["patch"])
        self.agg = GridAggregator(shape, cfg["out_channels"], traffic["patch"], mode="average")
        self.checked = set(inputs.checked_requests(traffic, seed))
        self.kept: List[Tuple[int, torch.Tensor]] = []
        common.sync(device)
        self.phases.mark("weights, volumes")
        for _ in range(traffic["warmup_requests"]):
            self._serve(0)
        common.sync(device)
        self.phases.mark("warm-up requests")

    def volumes_of(self, i: int) -> List[int]:
        return request_volumes(self.order, self.units_per_item, i)

    def _serve(self, i: int) -> List[torch.Tensor]:
        from unet_bssfp_tpu_torch.data.sampler import extract_patches

        p, n = self.traffic["patch"], len(self.starts)
        x = torch.cat([extract_patches(self.pool[v], self.starts, p) for v in self.volumes_of(i)])
        if self.fault == "half":
            half = self.predict(x[:len(x) // 2])
            y = torch.cat([half, torch.zeros_like(half)])
        else:
            y = self.predict(x)
        if self.fault == "altered":  # the first patch's answer replaced by the second's
            y = torch.cat([y[1:2], y[1:]])
        return [self.agg.stitch(y[j * n:(j + 1) * n]) for j in range(self.units_per_item)]

    def item(self, i: int, annotate: bool = False) -> None:
        """The window's ``i``-th request (in the span ``portbench.request``
        where ``annotate``: the program's own spans name its extract,
        predict and stitch); its answers kept where it is one of the
        checked ones."""
        with record_function("portbench.request") if annotate else contextlib.nullcontext():
            outs = self._serve(i)
        if i in self.checked:
            self.kept += list(zip(self.volumes_of(i), outs))

    def check(self) -> Dict[str, float]:
        kept, pool = self.kept, self.pool
        del self.predict, self.kept
        common.release()
        if not kept:
            return {"out_rel_l2": float("inf"), "out_max_abs": float("inf")}
        w = _weights(self.cfg, self.seed, self.device)
        with common.float32_reference():  # one reference per distinct volume
            ref = {v: ref_train.serve_volume(w, pool[v], self.cfg, self.traffic["patch"])
                   for v in sorted({v for v, _ in kept})}
        return check.volume_gaps((out, ref[v]) for v, out in kept)


def request_volumes(order: List[int], k: int, i: int) -> List[int]:
    """The pool volumes request ``i`` takes: ``order``'s entries ``i·k`` to
    ``i·k + k − 1``, cycling."""
    return [order[(i * k + j) % len(order)] for j in range(k)]


def _weights(cfg: dict, seed: int, device):
    gen_shapes, _ = ref_models.gan_shapes(cfg)
    return inputs.weights(gen_shapes, seed, "gen", device, "random")


def setup(cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None):
    return ServeCohort(cfg, traffic, seed, device, fault)


def control(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, float]:
    """The reference in fp8 in the program's place, over the volumes of the
    checked requests, against the float32 reference."""
    w = _weights(cfg, seed, device)
    pool = inputs.volumes(traffic, seed, cfg["in_channels"], device)
    order = inputs.volume_order(traffic, seed)
    k, p = traffic["volumes_per_request"], traffic["patch"]
    vols = sorted({v for i in inputs.checked_requests(traffic, seed)
                   for v in request_volumes(order, k, i)})
    with common.float32_reference():
        return check.volume_gaps(
            (ref_train.serve_volume(w, pool[v], cfg, p, ref_models.fp8),
             ref_train.serve_volume(w, pool[v], cfg, p)) for v in vols)


def _patches(traffic: dict) -> int:
    """Patches a request: its volumes' grid patches."""
    return traffic["volumes_per_request"] * len(ref_train.grid_starts(traffic["volume"],
                                                                      traffic["patch"]))


def flops(cfg: dict, traffic: dict):
    """Model FLOPs of a request, and of its 3³ convs alone."""
    args = (_patches(traffic), traffic["patch"], cfg["in_channels"], cfg["out_channels"],
            cfg["unet_in_channels"], cfg["features"])
    return pf.serve_chunk(*args), pf.serve_chunk(*args, only_kernels=(3, 4))


def kernel_work(cfg: dict, traffic: dict):
    """K10 a request: the generator's eval forward over its patches."""
    return common.norm_act_work(cfg, _patches(traffic), traffic["patch"], ("eval",))
