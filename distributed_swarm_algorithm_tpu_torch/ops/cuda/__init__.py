"""Hand-written CUDA kernels: wrappers, plain versions and the build."""
