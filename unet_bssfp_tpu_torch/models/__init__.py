"""Generator modules (NDHWC activations, Flax parameter names)."""
