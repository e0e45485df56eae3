"""Model tier: the senone bank, the embedded sentence-HMM topology, state
tying and context-dependent unit machinery."""

from poccala_tpu_torch.models.senone_bank import SenoneBank
from poccala_tpu_torch.models.topology import EmbeddedHMM, build_embedded, build_embedded_batch
from poccala_tpu_torch.models.context import (
    CDInventory,
    ContextTrees,
    build_cd_bank,
    build_cd_lexicon,
    grow_context_trees,
)

__all__ = [
    "SenoneBank", "EmbeddedHMM", "build_embedded", "build_embedded_batch",
    "CDInventory", "ContextTrees", "build_cd_bank", "build_cd_lexicon",
    "grow_context_trees",
]
