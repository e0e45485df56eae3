"""Model tier: the senone bank, the embedded sentence-HMM topology and
state tying."""

from poccala_tpu_torch.models.senone_bank import SenoneBank

__all__ = ["SenoneBank"]
