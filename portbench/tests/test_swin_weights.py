"""The Swin cell's own weight draw: ``inputs.weights(style="init")`` fills
every weight leaf that is not a conv kernel with 1.0, right for a norm's
scale and wrong for a linear layer; the driver draws the linear weights and
the relative-position bias tables N(0, 0.02²) itself. No linear weight of
the drawn dict is constant, and its names and shapes are the program's
``state_dict``'s, at the cell's own sizes."""

from __future__ import annotations

import torch

from portbench import spec
from portbench.drivers import swin_gan_train as drv
from unet_bssfp_tpu_torch.train.state import build_models


def test_linear_weights_are_drawn_and_named_as_the_program(bench):
    cell = spec.cell(bench, "swin-unetr-gan-train-b4-p96")
    cfg = spec.config(bench, cell["config"])
    gen_w, disc_w = drv.weights(cfg, 2026, "cpu")
    gen, disc = build_models(cfg["modality"], drv.model_config(cfg), "cpu")
    for drawn, model in ((gen_w, gen), (disc_w, disc)):
        assert {k: tuple(v.shape) for k, v in drawn.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
    tables = [k for k, v in gen_w.items() if drv.is_table(k, v.shape)]
    linear = [k for k in tables if k.endswith(".weight")]
    assert len(linear) == 4 * (4 * 2) + 4 and len(tables) == len(linear) + 8
    for k in tables:
        v = gen_w[k]
        assert v.min() < v.max(), k
        assert 0.015 < float(v.std()) < 0.025, k
    # the rest as the init style draws it: norm scales 1, biases 0
    assert torch.equal(gen_w["swin_unetr.swin.layers1.blocks.0.norm1.weight"], torch.ones(48))
    assert not gen_w["swin_unetr.swin.layers1.blocks.0.attn.qkv.bias"].any()
    # and it repeats for a repeated seed
    again, _ = drv.weights(cfg, 2026, "cpu")
    assert all(torch.equal(gen_w[k], again[k]) for k in gen_w)
