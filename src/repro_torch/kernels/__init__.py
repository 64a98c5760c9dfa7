"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the wrappers that pick between them by the device a tensor lies on."""
