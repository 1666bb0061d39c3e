"""Host ms from a request's call to its return, before the synchronise."""

from portbench import readers

read = readers.host_ms("serve")
