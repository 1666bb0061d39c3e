"""Device ms per step launched from the program's bssfp.*.optimizer spans (the generator's and the discriminator's together)."""

from portbench import readers

read = readers.phase_ms("train", "optimizer")
