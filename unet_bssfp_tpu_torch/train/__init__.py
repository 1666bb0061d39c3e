"""The GAN train state, its steps and the epoch loop; the multi-stage
regime."""

from unet_bssfp_tpu_torch.train.state import GANTrainState, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_predict_fn, make_train_step
from unet_bssfp_tpu_torch.train.loop import Trainer, build_trainer_args, train_model
from unet_bssfp_tpu_torch.train.multistage import (
    SupervisedState,
    build_multi_input_unet,
    create_supervised_state,
    make_stage_optimizer,
    make_supervised_eval_step,
    make_supervised_train_step,
    run_multistage,
    transfer_params,
)

__all__ = [
    "GANTrainState",
    "create_gan_state",
    "make_train_step",
    "make_eval_step",
    "make_predict_fn",
    "train_model",
    "Trainer",
    "build_trainer_args",
    "SupervisedState",
    "build_multi_input_unet",
    "create_supervised_state",
    "make_stage_optimizer",
    "make_supervised_train_step",
    "make_supervised_eval_step",
    "transfer_params",
    "run_multistage",
]
