"""Compute ops tier: frontend, VAD, GMM scoring, HMM dynamic programming,
grouped k-means and EM, and the CUDA kernels."""
