"""Share of a request's traced device time launched from its bssfp.extract, bssfp.predict and bssfp.stitch spans, %."""

from portbench import readers

read = readers.coverage("serve")
