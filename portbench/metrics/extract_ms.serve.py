"""Device ms per request launched from the program's bssfp.extract spans."""

from portbench import readers

read = readers.span_ms("serve", "bssfp.extract")
