"""The public model surface (counterpart of ``src/model.py``), built on the
port's functions.

The same names: ``Generator``, ``Discriminator``, ``DownSampleConv``,
``PerceptualL1Loss``, ``bSSFPToDWITensorModel``, ``MultiInputUNetModel``,
``check_input_shape``. ``bSSFPToDWITensorModel`` bundles what the reference
LightningModule carried (``src/model.py:141-361``): the networks, the loss,
two AdamW optimizers and the GAN steps of ``train/steps.py``.
``MultiInputUNetModel`` holds the multi-stage regime's (stage, modality,
weights) and switches stages as the reference's
``change_training_state`` does. Everything runs on ``cuda`` unless the
caller passes ``device="cpu"``; the steps launch the kernels that
``make_train_step`` and the supervised step launch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from unet_bssfp_tpu_torch.config import Config
from unet_bssfp_tpu_torch.models import Discriminator, Generator, MultiInputUNet  # noqa: F401
from unet_bssfp_tpu_torch.models.layers import ConvBlock as DownSampleConv  # noqa: F401
from unet_bssfp_tpu_torch.models.medicalnet import (
    MedicalNetResNet10,
    load_medicalnet,
    perceptual_distance,
)
from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
from unet_bssfp_tpu_torch.ops.losses import l1_loss
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, same_device
from unet_bssfp_tpu_torch.train.checkpoint import load_checkpoint
from unet_bssfp_tpu_torch.train.loop import resolve_with_perceptual
from unet_bssfp_tpu_torch.train.multistage import (
    build_multi_input_unet,
    create_supervised_state,
    make_supervised_eval_step,
    make_supervised_train_step,
    transfer_params,
)
from unet_bssfp_tpu_torch.train.state import GANTrainState, create_gan_state, resolve_device
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_predict_fn, make_train_step

Device = Union[str, torch.device, None]


class PerceptualL1Loss:
    """L1 + scaled MedicalNet perceptual distance, returned as a dict
    (reference ``PerceptualL1Loss``, ``src/model.py:123-138``).

    Without converted Med3D weights the feature extractor is a fixed random
    network (``models/medicalnet.py``); pass ``net`` (a
    ``MedicalNetResNet10`` holding other weights) to use those."""

    def __init__(self, perceptual_factor: float = 1e3,
                 net: Optional[MedicalNetResNet10] = None, seed: int = 0,
                 weights_path: Optional[str] = None, device: Device = None):
        self.perceptual_factor = perceptual_factor
        self.net = (net if net is not None
                    else load_medicalnet(weights_path, seed, device=resolve_device(device)))

    def get_perceptual_model(self) -> MedicalNetResNet10:
        return self.net

    def perceptual_fn(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return perceptual_distance(self.net, y_hat, y)

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"L1": l1_loss(y_hat, y),
                "Perceptual": self.perceptual_fn(y_hat, y) * self.perceptual_factor}


class bSSFPToDWITensorModel:
    """Stateful counterpart of the reference LightningModule
    (``src/model.py:141-165``): the same hyperparameters (lr 1e-3, batch 8,
    perceptual_factor 1e3, recon_factor 1e2), two AdamW optimizers, the GAN
    step of ``train/steps.py``. ``init(seed)`` draws the state and binds
    ``train_step(state, x, y) -> metrics`` and ``eval_step`` to
    its models (the port's steps are bound to module instances), and
    ``predict(x)`` is the eval-mode generator forward."""

    def __init__(self, input_modality: str, lr: float = 1e-3, batch_size: int = 8,
                 perceptual_factor: float = 1e3, recon_factor: float = 1e2,
                 config: Optional[Config] = None,
                 # None = auto, as train/loop.py:resolve_with_perceptual
                 # resolves it: on iff converted Med3D weights resolve and
                 # the factor is within the validated bound
                 with_perceptual: Optional[bool] = None,
                 mesh: Optional[Mesh] = None, device: Device = None):
        config = config or Config()
        tcfg = dataclasses.replace(config.train, lr=lr, perceptual_factor=perceptual_factor,
                                   recon_factor=recon_factor, with_perceptual=with_perceptual)
        self.config = dataclasses.replace(config, train=tcfg)
        self.input_modality = input_modality
        self.batch_size = batch_size
        self.mesh = mesh
        if mesh is not None:
            first = mesh.devices[0][0]
            if device is not None and not same_device(device, first):
                raise ValueError(f"device {device} is not the first device of {mesh}")
            device = first
        self.device = resolve_device(device)
        self.recon_criterion = (
            PerceptualL1Loss(perceptual_factor, weights_path=tcfg.medicalnet_weights,
                             device=self.device)
            if resolve_with_perceptual(tcfg) else None)
        self.state: Optional[GANTrainState] = None
        self.train_step = self.eval_step = None

    @property
    def gen(self) -> Generator:
        return self._state().gen

    @property
    def discr(self) -> Discriminator:
        return self._state().disc

    def _state(self) -> GANTrainState:
        if self.state is None:
            raise RuntimeError("call init() or load_from_checkpoint() first")
        return self.state

    def init(self, seed: int = 0) -> GANTrainState:
        """A fresh state drawn from ``seed`` (``create_gan_state``) and the
        steps bound to its models."""
        cfg = self.config
        self.state = create_gan_state(seed, self.input_modality, cfg.model, cfg.train,
                                      self.device, mesh=self.mesh)
        perceptual_fn = (self.recon_criterion.perceptual_fn
                         if self.recon_criterion is not None else None)
        self.train_step = make_train_step(self.gen, self.discr, cfg.train, perceptual_fn,
                                          self.mesh, reuse_fake=cfg.train.reuse_fake)
        self.eval_step = make_eval_step(self.gen, self.discr, cfg.train, perceptual_fn,
                                        self.mesh)
        return self.state

    @classmethod
    def load_from_checkpoint(cls, checkpoint_path: str, input_modality: str,
                             **kw) -> "bSSFPToDWITensorModel":
        """A model built with ``kw`` whose state is the step at
        ``checkpoint_path`` (its directory or its ``state.pt``)."""
        model = cls(input_modality, **kw)
        model.init()
        load_checkpoint(checkpoint_path, model.state)
        return model

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The eval-mode generator forward (``make_predict_fn``, made anew:
        it puts the generator in eval mode, which a train step left)."""
        return make_predict_fn(self.gen, self.mesh)(x)

    forward = __call__ = predict

    def unpack_batch(self, batch: Dict[str, torch.Tensor], test: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Input/target selection (reference ``src/model.py:195-199``): the
        un-augmented ``dwi-tensor_orig`` in train and val, ``dwi-tensor`` in
        test."""
        return batch[self.input_modality], batch["dwi-tensor" if test else "dwi-tensor_orig"]


class MultiInputUNetModel:
    """Stateful wrapper of :class:`MultiInputUNet` over the multi-stage
    regime (the reference calls ``model.change_training_state(state,
    modality)``, ``src/eval.py:18-19,199``): it holds the stage, the modality
    and the net with its weights, and rebuilds the stage's optimizer and
    steps on a change, grafting the trained backbone across modalities."""

    def __init__(self, state: Optional[TrainingState] = None, config: Optional[Config] = None,
                 device: Device = None):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.state_enum = state or TrainingState.PRETRAIN
        self.modality = "dwi-tensor"
        self._build(build_multi_input_unet(self.modality, self.config.model, self.device))

    def _build(self, net: MultiInputUNet,
               params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """The stage's state on ``net`` (``params`` loaded, else the seed's
        draw), its optimizer and its steps."""
        tcfg = self.config.train
        self.net = net
        self.sup_state = create_supervised_state(tcfg.seed, net, tcfg, self.state_enum,
                                                 state_dict=params)
        self.train_step = make_supervised_train_step(net, tcfg)
        self.eval_step = make_supervised_eval_step(net, tcfg)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The net's current weights (its ``state_dict``)."""
        return self.net.state_dict()

    def step(self, x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training step of the current stage; the net keeps the trained
        weights, so ``change_training_state`` grafts them."""
        return self.train_step(self.sup_state, x, y)

    def change_training_state(self, state: TrainingState, modality: str) -> None:
        """Switch stage and modality (reference ``src/eval.py:199``): a new
        modality's net takes the trained backbone (``transfer_params``, its
        head fresh unless the groups match); TRANSFER freezes the backbone,
        FINE_TUNE trains everything at ``finetune_lr``. The stage's optimizer
        starts anew."""
        params = {k: v.detach().clone() for k, v in self.net.state_dict().items()}
        self.state_enum = state
        net = self.net
        if modality != self.modality:
            self.modality = modality
            net = build_multi_input_unet(modality, self.config.model, self.device)
            params = transfer_params(params, net, seed=1)
        self._build(net, params)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The eval-mode forward."""
        self.net.eval()
        with torch.inference_mode():
            return self.net(x)


def check_input_shape(volume_shape, strides=(2, 2, 2, 2)) -> None:
    """Validate volume-dim/stride divisibility for the U-Net depth (reference
    ``check_input_shape``, ``src/model.py:95-120``, against the actual
    architecture: 4 pooling stages need /2^4 divisibility)."""
    factor = int(np.prod(strides))
    for v in volume_shape[:3]:
        if v % factor != 0:
            raise ValueError(
                f"dim {v} not divisible by {factor} "
                f"(4 pooling stages); pad or crop first"
            )
