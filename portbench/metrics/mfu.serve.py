"""Model FLOPs per second over the window as a share of the bf16 peak, %."""

from portbench import readers

read = readers.mfu("serve")
