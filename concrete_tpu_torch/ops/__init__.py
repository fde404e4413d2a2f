"""Hand-written CUDA kernels of the blind rotate, with their plain versions."""
