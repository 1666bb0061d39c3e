"""Calls per step that wait for the device (portbench/spans.py BLOCKING) inside the program's bssfp.* spans."""

from portbench import readers

read = readers.syncs("train")
