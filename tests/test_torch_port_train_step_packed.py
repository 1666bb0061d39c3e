"""The 3-step train-step trajectory of test_torch_port_train_step.py with
``packed`` on: the JAX package's Pallas conv (interpret mode) and its custom
VJPs against the port's packed conv, relayout and pool under autograd; and
one step with ``reuse_fake`` (the discriminator takes the generator phase's
fake: the generator and its BatchNorm statistics run once per step)."""

import torch

from test_torch_port_train_step import trajectory_matches_jax

torch.set_num_threads(1)


def test_train_step_trajectory_matches_jax_packed():
    trajectory_matches_jax(packed=True)


def test_train_step_reuse_fake_matches_jax():
    trajectory_matches_jax(packed=False, reuse_fake=True, n_steps=1)
