"""PyTorch/CUDA port of ``unet_bssfp_tpu`` for NVIDIA Hopper.

Imports torch, numpy and the standard library only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the kernels' plain
versions serve CPU tensors.
"""
