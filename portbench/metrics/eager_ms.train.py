"""Device ms per step in the ATen elementwise, reduction and copy groups."""

from portbench import readers

read = readers.eager_ms("train")
