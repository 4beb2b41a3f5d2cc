"""Hand-written kernels of the port and their plain PyTorch versions."""
