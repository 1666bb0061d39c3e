"""Volumes stitched per second over the window."""

from portbench import readers

read = readers.rate("serve")
