"""Plain PyTorch reference of the benchmark's models, losses, optimizer and
stitching: float32, NCDHW inside, no kernel, nothing of the program.

It takes weights as a ``{name: tensor}`` dict keyed by the parameter names
the models carry, the inputs as NDHWC tensors, and the dropout draws as a
seeded ``torch.Generator`` with the layout each block draws its mask in
(:class:`~portbench.reference.models.Masks`). ``quant``, where given, rounds
both operands and the result of every convolution and every activation
the models keep (norm, nonlinearity), in the forward and the backward: the
benchmark's control computes the reference in fp8 through it.
"""
