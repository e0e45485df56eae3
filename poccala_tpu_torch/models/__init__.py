"""Model tier: the senone bank and the embedded sentence-HMM topology."""

from poccala_tpu_torch.models.senone_bank import SenoneBank

__all__ = ["SenoneBank"]
