"""K10's least time per step (its least bytes, portbench/flops.py, at the HBM's peak) over its device time, %."""

from portbench import readers

read = readers.kernel_roofline("train", "norm_act")
