"""Share of the conv groups' device time that the 3x3x3 and 4x4x4 convs' FLOPs need at the bf16 peak, %."""

from portbench import readers

read = readers.conv_roofline("train")
