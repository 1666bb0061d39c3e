"""The plain reference against the program at a tiny size on the CPU, in
float32, with the same seeded weights, inputs and dropout draws."""

from __future__ import annotations

import pytest
import torch

from portbench import inputs
from portbench.drivers import common, gan_train, serve_cohort, supervised_train
from portbench.reference import losses, models, train
from unet_bssfp_tpu_torch.config import TrainConfig
from unet_bssfp_tpu_torch.data.sampler import GridAggregator, grid_patch_starts
from unet_bssfp_tpu_torch.models.layers import bind_dropout_generator
from unet_bssfp_tpu_torch.ops.metrics import ssim3d
from unet_bssfp_tpu_torch.train.multistage import build_multi_input_unet
from unet_bssfp_tpu_torch.train.state import build_models, make_optimizer

TOL = dict(rtol=2e-4, atol=2e-5)


def test_shapes_are_the_programs(bench, tiny):
    for workload in ("gan-train-b16", "multistage-finetune-b8"):
        _, cfg, _ = tiny(workload)
        if cfg["model"] == "gan":
            gen, disc = build_models(cfg["modality"], common.model_config(cfg), "cpu")
            want = models.gan_shapes(cfg)
            got = tuple({k: tuple(v.shape) for k, v in m.state_dict().items()} for m in (gen, disc))
        else:
            net = build_multi_input_unet(cfg["modality"], common.model_config(cfg), "cpu")
            want = models.multi_input_shapes(cfg)
            got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        assert got == want


@pytest.mark.parametrize("packed", [None, True])
@pytest.mark.parametrize("train_mode", [False, True])
def test_generator_forward(tiny, packed, train_mode):
    _, cfg, traffic = tiny("gan-train-b16", packed=packed)
    gen, _ = build_models(cfg["modality"], common.model_config(cfg), "cpu")
    w = inputs.weights(models.gan_shapes(cfg)[0], 3, "gen", "cpu", "random")
    gen.load_state_dict(w)
    x, _ = inputs.patch_batches(traffic, 3, 24, 6, "cpu")
    gen.train(train_mode)
    bind_dropout_generator(gen, inputs.generator("cpu", 3, "dropout"))
    got = gen(x[0])
    masks = models.Masks(inputs.generator("cpu", 3, "dropout"), cfg["dropout"])
    want = models.generator(w, x[0], cfg, train_mode, masks,
                            common.packed_layout(cfg, traffic["patch"], "cpu"))
    torch.testing.assert_close(got, want, **TOL)


def test_discriminator_forward(tiny):
    _, cfg, traffic = tiny("gan-train-b16")
    _, disc = build_models(cfg["modality"], common.model_config(cfg), "cpu")
    w = inputs.weights(models.gan_shapes(cfg)[1], 4, "disc", "cpu", "random")
    disc.load_state_dict(w)
    x, y = inputs.patch_batches(traffic, 4, 24, 6, "cpu")
    torch.testing.assert_close(disc(x[0], y[0]), models.discriminator(w, x[0], y[0], cfg), **TOL)


def test_multi_input_forward(tiny):
    _, cfg, traffic = tiny("multistage-finetune-b8", packed=True)
    net = build_multi_input_unet(cfg["modality"], common.model_config(cfg), "cpu")
    w = inputs.weights(models.multi_input_shapes(cfg), 5, "net", "cpu", "random")
    net.load_state_dict(w)
    bind_dropout_generator(net, inputs.generator("cpu", 5, "dropout"))
    x, _ = inputs.patch_batches(traffic, 5, 24, 6, "cpu")
    masks = models.Masks(inputs.generator("cpu", 5, "dropout"), cfg["dropout"])
    torch.testing.assert_close(net(x[0]), models.multi_input_unet(w, x[0], cfg, True, masks, True),
                               **TOL)


def test_ssim_and_losses():
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand((2, 16, 16, 16, 3), generator=g), torch.rand((2, 16, 16, 16, 3), generator=g)
    torch.testing.assert_close(losses.ssim3d(a, b), ssim3d(a, b), rtol=1e-5, atol=1e-6)
    z = torch.randn(40, generator=g) * 3
    want = torch.mean(torch.clamp(z, min=0) + torch.log1p(torch.exp(-z.abs())))
    torch.testing.assert_close(losses.bce_with_logits(z, 0.0), want)


def test_adamw_is_torchs():
    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    mine = {"p": p0.clone().requires_grad_(True)}
    opt = train.AdamW(mine, 1e-3, 0.9, 0.999, 0.01)
    theirs = p0.clone().requires_grad_(True)
    topt = make_optimizer([theirs], TrainConfig())
    for gr in grads:
        mine["p"].grad = gr.clone()
        opt.step()
        theirs.grad = gr.clone()
        topt.step()
    torch.testing.assert_close(mine["p"], theirs, rtol=1e-6, atol=1e-7)


def test_stitch_is_the_samplers():
    shape, p = (24, 32, 32), 16
    assert [tuple(s) for s in grid_patch_starts(shape, p).tolist()] == train.grid_starts(shape, p)
    g = torch.Generator().manual_seed(2)
    vol = torch.randn(shape + (5,), generator=g)
    ident = lambda t: t[..., :3] * 2.0  # noqa: E731
    agg = GridAggregator(shape, 3, p)
    starts = grid_patch_starts(shape, p)
    patches = torch.stack([vol[a:a + p, b:b + p, c:c + p] for a, b, c in starts.tolist()])
    torch.testing.assert_close(train.serve_volume({}, vol, {}, p, predict=ident),
                               agg.stitch(ident(patches)))


@pytest.mark.parametrize("workload,packed", [("gan-train-b16", None), ("gan-train-b16", True),
                                             ("multistage-finetune-b8", True),
                                             ("multistage-transfer-b8", None)])
def test_training_record_matches(tiny, workload, packed):
    """The program's checked steps and the reference's agree in float32 (the GAN's later
    losses to 1e-4: the sign-like first Adam step amplifies rounding)."""
    _, cfg, traffic = tiny(workload, packed=packed)
    drv = gan_train if cfg["model"] == "gan" else supervised_train
    c = drv.setup(cfg, traffic, 6, "cpu")
    gaps = c.check()
    assert gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-2, gaps


def test_serving_matches(tiny):
    _, cfg, traffic = tiny("gan-serve-cohort-b32")
    c = serve_cohort.setup(cfg, traffic, 7, "cpu")
    for i in sorted(c.checked):
        c.item(i)
    gaps = c.check()
    assert max(gaps.values()) < 1e-5, gaps
