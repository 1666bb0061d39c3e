"""Closed loop of GAN training steps (``make_train_step``) with the
SwinUNETR generator (``Generator(backbone="swin_unetr")``), one batch of
resident seeded crops a step.

As ``gan_train``: set-up builds the one training state the window drives
and drives it through the first ``checked_steps`` steps with the window's
own call and feed; their losses, first gradients and parameter change are
the program's record, which :meth:`SwinGanTrain.check` holds against
:func:`portbench.reference.swin_unetr.gan_steps` after the window. The
weights are the configuration's initialisation drawn from the seed: conv
kernels as ``inputs.weights(style="init")`` draws them, and the linear
weights and relative-position bias tables N(0, 0.02²) from a draw of their
own (``init`` would fill every 2-D weight with 1.0)."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from portbench import check, inputs, trace
from portbench import swin_flops as sf
from portbench.drivers import common
from portbench.reference import models as ref_models
from portbench.reference import swin_unetr as ref_swin
from portbench.reference import train as ref_train

# The attention kernels' names: the keys of groups.json's attention group.
ATTENTION_KEYS = tuple(next(keys for group, keys in trace.GROUPS["groups"]
                            if group.startswith("attention")))
# The sizes SwinUNETR3D builds besides ``feature_size`` (MONAI's BTCV
# setting); a configuration has to state them as they are.
FIXED_SIZES = {"depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24], "window_size": 7,
               "patch_size": 2, "mlp_ratio": 4.0}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for the configuration: the GAN's head
    and PatchGAN, the SwinUNETR backbone at ``cfg["swin"]``'s feature size
    (its other sizes must be :data:`FIXED_SIZES`)."""
    from unet_bssfp_tpu_torch.config import ModelConfig

    s = cfg["swin"]
    other = {k: s[k] for k in FIXED_SIZES}
    if other != FIXED_SIZES:
        raise ValueError(f"the program builds SwinUNETR at {FIXED_SIZES}, not {other}")
    return ModelConfig(
        backbone="swin_unetr", dropout=cfg["dropout"], out_channels=cfg["out_channels"],
        compute_dtype=cfg["compute_dtype"], packed=cfg["packed"],
        unet_in_channels=cfg["unet_in_channels"],
        disc_negative_slope=cfg["disc_negative_slope"],
        disc_features=tuple(cfg["disc_features"]), swin_feature_size=s["feature_size"])


def is_table(name: str, shape) -> bool:
    """A leaf drawn N(0, 0.02²): a linear layer's weight or a bias table."""
    return (len(shape) == 2 and name.endswith(".weight")) or \
        name.endswith(".relative_position_bias_table")


def weights(cfg: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                    Dict[str, torch.Tensor]]:
    """The generator's and the discriminator's float32 weights from the
    seed: ``inputs.weights(style="init")``, then every linear weight and
    bias table N(0, 0.02²) truncated at ±2 (timm's and MONAI's
    ``trunc_normal_(std=0.02)``) from one draw of their own."""
    gen_shapes, disc_shapes = ref_swin.swin_gan_shapes(cfg)
    gen = inputs.weights(gen_shapes, seed, "gen", device, "init")
    names = [k for k, shape in gen_shapes.items() if is_table(k, shape)]
    sizes = [math.prod(gen_shapes[k]) for k in names]
    g = inputs.generator(device, seed, "weights", "gen", "tables")
    flat = torch.randn(sum(sizes), generator=g, device=device).mul_(0.02).clamp_(-2.0, 2.0)
    for k, z in zip(names, torch.split(flat, sizes)):
        gen[k] = z.view(gen_shapes[k])
    return gen, inputs.weights(disc_shapes, seed, "disc", device, "init")


class SwinGanTrain(common.TrainLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None):
        from unet_bssfp_tpu_torch.train.state import GANTrainState, build_models, make_optimizer
        from unet_bssfp_tpu_torch.train.steps import make_train_step

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.fault = device, fault
        self.units_per_item = traffic["batch"]
        self.phases = common.Phases()
        tcfg = common.train_config(cfg)
        gen, disc = build_models(cfg["modality"], model_config(cfg), device)
        self.phases.mark("models")
        gen_w, disc_w = weights(cfg, seed, device)
        gen.load_state_dict(gen_w, strict=True)
        disc.load_state_dict(disc_w, strict=True)
        self.state = GANTrainState(step=0, rng=inputs.generator(device, seed, "dropout"),
                                   gen=gen, disc=disc,
                                   gen_opt=make_optimizer(gen.parameters(), tcfg),
                                   disc_opt=make_optimizer(disc.parameters(), tcfg))
        if fault == "unchanged":
            for opt in (self.state.gen_opt, self.state.disc_opt):
                opt.step = lambda *a, **k: None
        self.step = make_train_step(gen, disc, tcfg)
        self.x, self.y = inputs.patch_batches(traffic, seed, cfg["in_channels"],
                                              cfg["out_channels"], device)
        common.sync(device)
        self.phases.mark("weights, optimizers, batches")
        named = {**{f"gen.{k}": p for k, p in gen.named_parameters()},
                 **{f"disc.{k}": p for k, p in disc.named_parameters()}}
        start = {f"gen.{k}": v for k, v in gen_w.items()}
        start.update({f"disc.{k}": v for k, v in disc_w.items()})
        losses, grad1 = [], {}
        for i in range(traffic["checked_steps"]):
            m = self._step(i)
            losses.append([m["train_gen_loss"], m["train_discr_loss"]])
            if i == 0:
                for who, opt in (("gen.", self.state.gen_opt), ("disc.", self.state.disc_opt)):
                    grad1.update(common.first_gradients(
                        {k: p for k, p in named.items() if k.startswith(who)}, opt, tcfg.b1))
        self.record = common.record(losses, grad1, named, start)
        common.sync(device)
        self.phases.mark("checked steps")

    def reference(self) -> ref_train.Record:
        return reference(self.cfg, self.traffic, self.seed, self.device)


def reference(cfg: dict, traffic: dict, seed: int, device, quant=None) -> ref_train.Record:
    """The reference's record of the checked steps from the same weights
    and batches (no dropout: the configuration's rates are 0)."""
    gen_w, disc_w = weights(cfg, seed, device)
    x, y = inputs.patch_batches(traffic, seed, cfg["in_channels"], cfg["out_channels"], device)
    n = traffic["checked_steps"]
    batches = [(x[i % len(x)], y[i % len(y)]) for i in range(n)]
    del x, y
    stats = ("running_mean", "running_var")
    with common.float32_reference():
        return ref_swin.gan_steps(
            gen_w, disc_w, [k for k in gen_w if not k.endswith(stats)],
            [k for k in disc_w if not k.endswith(stats)], batches, cfg, cfg["train"], quant)


def setup(cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None
          ) -> SwinGanTrain:
    return SwinGanTrain(cfg, traffic, seed, device, fault)


def control(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, float]:
    """The numbers of the reference computed in fp8 in the program's place."""
    low = reference(cfg, traffic, seed, device, ref_models.fp8)
    common.release()
    return check.training_gaps(low, reference(cfg, traffic, seed, device))


def flops(cfg: dict, traffic: dict):
    """Model FLOPs of a step, and of its convs and linear layers alone (the
    conv groups' work; attention left out)."""
    return sf.step_flops(cfg, traffic)


def kernel_work(cfg: dict, traffic: dict):
    """The attention kernels' least work a step, and K10's where the
    full-resolution blocks run packed (the model's gate reads twice the
    feature size, decoder1's concatenated width)."""
    work = {"window_attn": sf.window_attn_work(cfg, traffic, ATTENTION_KEYS)}
    widest = dict(cfg, features=[2 * cfg["swin"]["feature_size"]])
    if common.packed_layout(widest, traffic["patch"], "cuda"):
        work["norm_act"] = sf.norm_act_work(cfg, traffic)
    return work
