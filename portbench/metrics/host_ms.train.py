"""Host ms from a step's call to its return, before the synchronise."""

from portbench import readers

read = readers.host_ms("train")
