"""Compute ops tier: frontend, VAD, GMM scoring and its CUDA kernel."""
