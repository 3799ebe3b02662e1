"""Hand-written CUDA kernels for axhelm (precomputed, trilinear), their
build, their wrapper and their plain PyTorch versions."""
