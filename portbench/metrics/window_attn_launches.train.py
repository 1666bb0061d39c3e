"""Window attention calls per step, by the program's own counter (ops/window_attention.py)."""

from portbench import readers

read = readers.launches("train", "window_attention")
