"""Model tier: the senone bank."""

from poccala_tpu_torch.models.senone_bank import SenoneBank

__all__ = ["SenoneBank"]
