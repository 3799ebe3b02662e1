"""Hand-written CUDA kernels of the port."""
