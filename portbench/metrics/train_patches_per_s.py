"""Training patches completed per second over the window."""

from portbench import readers

read = readers.rate("train")
