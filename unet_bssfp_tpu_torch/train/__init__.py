"""The GAN train state, its steps, and the epoch loop."""

from unet_bssfp_tpu_torch.train.state import GANTrainState, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_predict_fn, make_train_step
from unet_bssfp_tpu_torch.train.loop import Trainer, train_model

__all__ = [
    "GANTrainState",
    "create_gan_state",
    "make_train_step",
    "make_eval_step",
    "make_predict_fn",
    "train_model",
    "Trainer",
]
