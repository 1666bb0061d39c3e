"""Share of a step's traced device time launched from its forward, loss, backward and optimizer spans, %."""

from portbench import readers

read = readers.coverage("train")
