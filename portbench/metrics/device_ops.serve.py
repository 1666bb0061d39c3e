"""Device operations per request, from the profiler trace."""

from portbench import readers

read = readers.device_ops("serve")
