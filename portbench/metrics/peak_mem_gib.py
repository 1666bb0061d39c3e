"""max_memory_allocated over the window, GiB."""

from portbench import readers

read = readers.peak_gib
