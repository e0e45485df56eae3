"""Training tier: Baum-Welch statistics and M-step, forced alignment,
the scheme-2 trainer, checkpoints."""
