"""Compute ops tier: frontend, VAD, GMM scoring, HMM dynamic programming,
grouped k-means and EM, distances, hierarchical clustering, SOM and PSO,
and the CUDA kernels."""
