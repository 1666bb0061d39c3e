"""Seconds from process start to the first timed step."""

from portbench import readers

read = readers.setup_s
