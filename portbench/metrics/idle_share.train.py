"""Share of the window's wall time with no device operation (traced busy time an item over the untraced window's time an item), %."""

from portbench import readers

read = readers.idle_share("train")
