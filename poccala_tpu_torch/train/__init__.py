"""Training tier: Baum-Welch statistics and M-step, forced alignment,
split-and-merge EM, the trainer of both schemes, checkpoints."""
