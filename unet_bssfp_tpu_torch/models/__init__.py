"""Generator modules (NDHWC activations, Flax parameter names)."""

from unet_bssfp_tpu_torch.models.discriminator import Discriminator
from unet_bssfp_tpu_torch.models.generator import Generator
from unet_bssfp_tpu_torch.models.layers import ConvBlock, Down, TwoConv, UpCat
from unet_bssfp_tpu_torch.models.medicalnet import MedicalNetResNet10
from unet_bssfp_tpu_torch.models.multi_input_unet import (
    MultiInputUNet,
    PReLUUNet,
    ResNetHead,
    TrainingState,
    stage_lr,
    trainable_mask,
)
from unet_bssfp_tpu_torch.models.unet import BasicUNet3D

__all__ = [
    "ConvBlock",
    "TwoConv",
    "Down",
    "UpCat",
    "BasicUNet3D",
    "Generator",
    "Discriminator",
    "MedicalNetResNet10",
    "MultiInputUNet",
    "PReLUUNet",
    "ResNetHead",
    "TrainingState",
    "trainable_mask",
    "stage_lr",
]
