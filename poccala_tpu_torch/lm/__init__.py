"""Language-model tier."""

from poccala_tpu_torch.lm.ngram import Ngram

__all__ = ["Ngram"]
