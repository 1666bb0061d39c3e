"""Device ms per request in the ATen elementwise, reduction and copy groups."""

from portbench import readers

read = readers.eager_ms("serve")
