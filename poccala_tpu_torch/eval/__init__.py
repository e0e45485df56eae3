"""Evaluation tier: error rates and parity checks."""

from poccala_tpu_torch.eval.wer import edit_distance, wer, evaluate_decoder

__all__ = ["edit_distance", "wer", "evaluate_decoder"]
