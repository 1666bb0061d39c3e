"""Closed loop of the multi-stage regime's supervised steps
(``make_supervised_train_step``) in the traffic's stage, one batch of
resident seeded patches a step; checked as ``gan_train`` checks the GAN's
first steps."""

from __future__ import annotations

from typing import Dict, Optional

from portbench import check, inputs
from portbench import flops as pf
from portbench.drivers import common
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train


def _stage(traffic: dict):
    from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState

    return TrainingState(traffic["stage"])


def _trained(names, stage: str):
    """The leaves the stage trains: every one, or in ``transfer`` the input
    head's alone (the thesis: the backbone frozen)."""
    return [k for k in names if stage != "transfer" or k.startswith("head")]


def _lr(cfg: dict, stage: str) -> float:
    return cfg["train"]["finetune_lr"] if stage == "finetune" else cfg["train"]["lr"]


class SupervisedTrain(common.TrainLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None):
        from unet_bssfp_tpu_torch.models.layers import bind_dropout_generator
        from unet_bssfp_tpu_torch.train.multistage import (
            SupervisedState,
            build_multi_input_unet,
            make_stage_optimizer,
            make_supervised_train_step,
        )

        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault
        self.units_per_item = traffic["batch"]
        self.phases = common.Phases()
        tcfg = common.train_config(cfg)
        net = build_multi_input_unet(cfg["modality"], common.model_config(cfg), device)
        self.phases.mark("models")
        start = _weights(cfg, seed, device)
        net.load_state_dict(start, strict=True)
        rng = inputs.generator(device, seed, "dropout")
        bind_dropout_generator(net, rng)
        opt = make_stage_optimizer(net, tcfg, _stage(traffic))
        if fault == "unchanged":
            opt.step = lambda *a, **k: None
        self.state = SupervisedState(step=0, rng=rng, net=net, opt=opt, stage=_stage(traffic))
        self.step = make_supervised_train_step(net, tcfg)
        self.x, self.y = inputs.patch_batches(traffic, seed, cfg["in_channels"],
                                              cfg["out_channels"], device)
        common.sync(device)
        self.phases.mark("weights, optimizer, batches")
        named = dict(net.named_parameters())
        losses, grad1 = [], {}
        for i in range(traffic["checked_steps"]):
            m = self._step(i)
            losses.append([m["train_loss"]])
            if i == 0:
                grad1 = common.first_gradients(
                    {k: named[k] for k in _trained(named, traffic["stage"])}, opt, tcfg.b1)
        self.record = common.record(losses, grad1, named, start)
        common.sync(device)
        self.phases.mark("checked steps")

    def reference(self) -> ref_train.Record:
        return reference(self.cfg, self.traffic, self.seed, self.device)


def _weights(cfg: dict, seed: int, device):
    return inputs.weights(ref_models.multi_input_shapes(cfg), seed, "net", device, "init",
                          cfg["prelu_init"])


def reference(cfg: dict, traffic: dict, seed: int, device, quant=None) -> ref_train.Record:
    w = _weights(cfg, seed, device)
    x, y = inputs.patch_batches(traffic, seed, cfg["in_channels"], cfg["out_channels"], device)
    batches = [(x[i % len(x)], y[i % len(y)]) for i in range(traffic["checked_steps"])]
    masks = ref_models.Masks(inputs.generator(device, seed, "dropout"), cfg["dropout"])
    stage = traffic["stage"]
    with common.float32_reference():
        return ref_train.supervised_steps(
            w, _trained(w, stage), batches, cfg, cfg["train"], _lr(cfg, stage), masks,
            common.packed_layout(cfg, traffic["patch"], device), quant)


def setup(cfg: dict, traffic: dict, seed: int, device, fault: Optional[str] = None):
    return SupervisedTrain(cfg, traffic, seed, device, fault)


def control(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, float]:
    low = reference(cfg, traffic, seed, device, ref_models.fp8)
    common.release()
    return check.training_gaps(low, reference(cfg, traffic, seed, device))


def flops(cfg: dict, traffic: dict):
    """Model FLOPs of a step, and of its 3³ convs alone."""
    args = (traffic["stage"], traffic["batch"], traffic["patch"], cfg["in_channels"],
            cfg["out_channels"], cfg["head_features"], cfg["features"])
    return pf.supervised_step(*args), pf.supervised_step(*args, only_kernels=(3, 4))


def kernel_work(cfg: dict, traffic: dict):
    """K10 a step: the U-Net's forward with its gradient and its backward
    (in ``transfer`` too: the head below it trains, so dx is taken)."""
    return common.norm_act_work(cfg, traffic["batch"], traffic["patch"], ("grad", "backward"))
