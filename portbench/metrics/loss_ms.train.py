"""Device ms per step launched from the program's bssfp.*.loss spans (the generator's and the discriminator's together)."""

from portbench import readers

read = readers.phase_ms("train", "loss")
