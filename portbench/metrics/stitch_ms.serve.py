"""Device ms per request launched from the program's bssfp.stitch spans."""

from portbench import readers

read = readers.span_ms("serve", "bssfp.stitch")
