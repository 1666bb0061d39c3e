"""K10's calls per step, forward and backward, by the program's own launch counters."""

from portbench import readers

read = readers.launches("train", "packed_norm_act", "packed_norm_act_backward")
