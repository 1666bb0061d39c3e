"""Device ms per request of K10, the packed stages' norm-dropout-activation kernels (norm_act_kernel_packed_*)."""

from portbench import readers

read = readers.kernel_ms("serve", ["norm_act_kernel_packed"])
