"""Compute ops tier: frontend, VAD, GMM scoring, HMM dynamic programming,
and their CUDA kernels."""
