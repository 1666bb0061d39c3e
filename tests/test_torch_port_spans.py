"""The port's own spans (``utils/profiling.py::span``) on the CPU: free of
``record_function`` with no profiler running; under ``torch.profiler``
the GAN step's nine, the supervised step's five in every stage, serving's
extract / predict / stitch and ``Trainer.fit``'s data wait in the Chrome
trace, each phase inside its step; and a step's outputs and parameters
bit-equal with and without a profiler."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.sampler import GridAggregator, extract_patches, grid_patch_starts
from unet_bssfp_tpu_torch.models import TrainingState
from unet_bssfp_tpu_torch.train.loop import Trainer
from unet_bssfp_tpu_torch.train.multistage import (
    build_multi_input_unet,
    create_supervised_state,
    make_supervised_train_step,
)
from unet_bssfp_tpu_torch.train.state import create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_predict_fn, make_train_step
from unet_bssfp_tpu_torch.utils import profiling

torch.set_num_threads(1)

PATCH = 16
GAN = ModelConfig(features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
                  compute_dtype="float32", dropout=0.0, packed=False)
MULTISTAGE = ModelConfig(multistage_features=(4, 8, 8, 16, 16, 4), compute_dtype="float32",
                         dropout=0.0, packed=False)
GAN_PHASES = [f"bssfp.{net}.{phase}" for net in ("gen", "disc")
              for phase in ("forward", "loss", "backward", "optimizer")]
NET_PHASES = [f"bssfp.net.{phase}" for phase in ("forward", "loss", "backward", "optimizer")]


def _batch(seed, c_in=24, n=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, PATCH, PATCH, PATCH, c_in), generator=g),
            torch.rand((n, PATCH, PATCH, PATCH, 6), generator=g))


def _spans(fn, tmp_path):
    """``fn()`` under a CPU profiler; the ``bssfp.*`` events of its
    exported Chrome trace in time order, as ``(name, start, end)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("bssfp.")]
    return sorted(spans, key=lambda s: s[1])


def _phases_inside_steps(spans, phases, steps):
    """The spans are ``steps`` × (a ``bssfp.step``, then ``phases`` in order
    inside it)."""
    assert [s[0] for s in spans] == (["bssfp.step"] + phases) * steps
    for k in range(steps):
        _, a, b = spans[k * (len(phases) + 1)]
        for _, pa, pb in spans[k * (len(phases) + 1) + 1:(k + 1) * (len(phases) + 1)]:
            assert a <= pa <= pb <= b


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = profiling.span("bssfp.step"), profiling.span("bssfp.gen.forward")
    assert first is second
    with first:
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("bssfp.step") is not first


def test_gan_step_spans_in_generator_then_discriminator_order(tmp_path):
    state = create_gan_state(0, "pc-bssfp", GAN, TrainConfig(), "cpu")
    step = make_train_step(state.gen, state.disc, TrainConfig())
    x, y = _batch(1)
    spans = _spans(lambda: [step(state, x, y) for _ in range(2)], tmp_path)
    _phases_inside_steps(spans, GAN_PHASES, steps=2)


@pytest.mark.parametrize("stage,modality", [(TrainingState.PRETRAIN, "dwi-tensor"),
                                            (TrainingState.TRANSFER, "pc-bssfp"),
                                            (TrainingState.FINE_TUNE, "pc-bssfp")])
def test_supervised_step_spans_in_every_stage(tmp_path, stage, modality):
    net = build_multi_input_unet(modality, MULTISTAGE, "cpu")
    state = create_supervised_state(0, net, TrainConfig(), stage)
    step = make_supervised_train_step(net, TrainConfig())
    x, y = _batch(2, c_in=6 if modality == "dwi-tensor" else 24)
    spans = _spans(lambda: step(state, x, y), tmp_path)
    _phases_inside_steps(spans, NET_PHASES, steps=1)


def test_serving_spans_extract_predict_stitch(tmp_path):
    state = create_gan_state(0, "pc-bssfp", GAN, TrainConfig(), "cpu")
    predict = make_predict_fn(state.gen)
    shape = (24, PATCH, PATCH)
    volume = torch.rand(shape + (24,), generator=torch.Generator().manual_seed(3))
    agg = GridAggregator(shape, 6, PATCH)

    def serve():
        patches = extract_patches(volume, grid_patch_starts(shape, PATCH), PATCH)
        return agg.stitch(predict(patches))

    spans = _spans(serve, tmp_path)
    assert [s[0] for s in spans] == ["bssfp.extract", "bssfp.predict", "bssfp.stitch"]
    assert spans[0][2] <= spans[1][1] and spans[1][2] <= spans[2][1]


class _Batches:
    """Two train batches of the loop's keys and no validation batch."""

    def setup(self):
        pass

    def train_batches(self, seed, keys, batch_divisor, device):
        for k in range(2):
            x, y = _batch(10 + k, c_in=6)
            yield {"dwi-tensor": x, "dwi-tensor_orig": y}

    def val_batches(self, *args, **kwargs):
        return iter(())


def test_fit_under_debug_traces_the_data_wait_before_each_step(tmp_path):
    cfg = Config(data=DataConfig(batch_size=2, patch_size=PATCH),
                 model=dataclasses.replace(GAN, packed=None),
                 train=TrainConfig(log_dir=str(tmp_path / "logs"),
                                   checkpoint_dir=str(tmp_path / "ckpts"), max_epochs=1,
                                   with_perceptual=False))
    Trainer(cfg, "dwi-tensor", device="cpu", debug=True).fit(_Batches())
    trace_dir = tmp_path / "logs" / "trace"
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"] in ("bssfp.data_wait", "bssfp.step")]
    # the two batches' waits, each before its step, and the wait that ends the stream
    assert names == ["bssfp.data_wait", "bssfp.step"] * 2 + ["bssfp.data_wait"]


def _gan_run(profiled, tmp_path):
    state = create_gan_state(5, "pc-bssfp", GAN, TrainConfig(), "cpu")
    step = make_train_step(state.gen, state.disc, TrainConfig())
    batches = [_batch(20 + k) for k in range(2)]

    def run():
        return [{k: v.clone() for k, v in step(state, x, y).items()} for x, y in batches]

    if profiled:
        out = []
        _spans(lambda: out.extend(run()), tmp_path)
    else:
        out = run()
    params = {f"gen.{k}": v for k, v in state.gen.state_dict().items()}
    params.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    return out, params


def test_step_is_bit_equal_with_and_without_a_profiler(tmp_path):
    (plain, plain_params), (traced, traced_params) = (_gan_run(False, tmp_path),
                                                      _gan_run(True, tmp_path))
    assert len(plain) == len(traced) == 2
    for a, b in zip(plain, traced):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert plain_params.keys() == traced_params.keys()
    for k, v in plain_params.items():
        assert torch.equal(v, traced_params[k]), k
    assert np.isfinite(float(plain[-1]["train_gen_loss"]))
