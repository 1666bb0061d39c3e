"""Device operations per step, from the profiler trace."""

from portbench import readers

read = readers.device_ops("train")
