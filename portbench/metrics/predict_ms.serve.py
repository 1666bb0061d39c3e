"""Device ms per request launched from the program's bssfp.predict spans."""

from portbench import readers

read = readers.span_ms("serve", "bssfp.predict")
