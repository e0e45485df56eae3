"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``)."""
