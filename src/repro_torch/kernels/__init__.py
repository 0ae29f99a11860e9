"""Hand-written CUDA kernels of the port, one directory each, with their
plain PyTorch versions beside them."""
