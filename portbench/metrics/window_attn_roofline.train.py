"""The window attention kernels' least time per step (portbench/swin_flops.py) over their device time, %."""

from portbench import readers

read = readers.kernel_roofline("train", "window_attn")
