"""Device ms per step of the Swin encoder's window attention kernels (SDPA's, by the attention group's names)."""

from portbench import readers
from portbench.drivers.swin_gan_train import ATTENTION_KEYS

read = readers.kernel_ms("train", ATTENTION_KEYS)
