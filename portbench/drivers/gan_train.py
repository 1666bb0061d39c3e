"""Closed loop of GAN training steps (``make_train_step``), one batch of
resident seeded patches a step.

Set-up builds the one training state the window drives, and drives it
through the first ``checked_steps`` steps with the window's own call and
feed (rows that all differ): its losses, its gradients as AdamW holds them
after the first step and its parameter change after the last are the
program's record, which :meth:`GanTrain.check` holds against the plain
reference's after the window."""

from __future__ import annotations

from typing import Dict, Optional

from portbench import check, inputs
from portbench import flops as pf
from portbench.drivers import common
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train


class GanTrain(common.TrainLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None):
        from unet_bssfp_tpu_torch.models.layers import bind_dropout_generator
        from unet_bssfp_tpu_torch.train.state import GANTrainState, build_models, make_optimizer
        from unet_bssfp_tpu_torch.train.steps import make_train_step

        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault
        self.units_per_item = traffic["batch"]
        self.phases = common.Phases()
        mcfg, tcfg = common.model_config(cfg), common.train_config(cfg)
        gen, disc = build_models(cfg["modality"], mcfg, device)
        self.phases.mark("models")
        gen_w, disc_w = _weights(cfg, seed, device)
        gen.load_state_dict(gen_w, strict=True)
        disc.load_state_dict(disc_w, strict=True)
        rng = inputs.generator(device, seed, "dropout")
        bind_dropout_generator(gen, rng)
        self.state = GANTrainState(step=0, rng=rng, gen=gen, disc=disc,
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
                grad1 = common.first_gradients(
                    {k: p for k, p in named.items() if k.startswith("gen.")},
                    self.state.gen_opt, tcfg.b1)
                grad1.update(common.first_gradients(
                    {k: p for k, p in named.items() if k.startswith("disc.")},
                    self.state.disc_opt, tcfg.b1))
        self.record = common.record(losses, grad1, named, start)
        common.sync(device)
        self.phases.mark("checked steps")

    def reference(self) -> ref_train.Record:
        return reference(self.cfg, self.traffic, self.seed, self.device)


def _weights(cfg: dict, seed: int, device):
    gen_shapes, disc_shapes = ref_models.gan_shapes(cfg)
    return (inputs.weights(gen_shapes, seed, "gen", device, "init"),
            inputs.weights(disc_shapes, seed, "disc", device, "init"))


def reference(cfg: dict, traffic: dict, seed: int, device, quant=None) -> ref_train.Record:
    """The reference's record of the checked steps from the same weights,
    batches and dropout draws."""
    gen_w, disc_w = _weights(cfg, seed, device)
    x, y = inputs.patch_batches(traffic, seed, cfg["in_channels"], cfg["out_channels"], device)
    n = traffic["checked_steps"]
    batches = [(x[i % len(x)], y[i % len(y)]) for i in range(n)]
    masks = ref_models.Masks(inputs.generator(device, seed, "dropout"), cfg["dropout"])
    stats = ("running_mean", "running_var")
    with common.float32_reference():
        return ref_train.gan_steps(
            gen_w, disc_w, [k for k in gen_w if not k.endswith(stats)],
            [k for k in disc_w if not k.endswith(stats)], batches, cfg, cfg["train"], masks,
            common.packed_layout(cfg, traffic["patch"], device), quant)


def setup(cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None) -> GanTrain:
    return GanTrain(cfg, traffic, seed, device, fault)


def control(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, float]:
    """The numbers of the reference computed in fp8 in the program's place."""
    low = reference(cfg, traffic, seed, device, ref_models.fp8)
    common.release()
    return check.training_gaps(low, reference(cfg, traffic, seed, device))


def flops(cfg: dict, traffic: dict):
    """Model FLOPs of a step, and of its 3³ and 4³ convs alone."""
    args = (traffic["batch"], traffic["patch"], cfg["in_channels"], cfg["out_channels"],
            cfg["unet_in_channels"], cfg["features"], cfg["disc_features"])
    return pf.gan_step(*args), pf.gan_step(*args, only_kernels=(3, 4))


def kernel_work(cfg: dict, traffic: dict):
    """K10 a step: G's forward with its gradient, its backward, and (unless
    ``reuse_fake``) its second forward in D's phase, in train mode without a
    gradient."""
    passes = ("grad", "backward") + (() if cfg["train"].get("reuse_fake") else ("no_grad",))
    return common.norm_act_work(cfg, traffic["batch"], traffic["patch"], passes)
