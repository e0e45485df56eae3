"""Lexicon tier: hanzi->pinyin G2P and the pronunciation lexicon."""

from poccala_tpu_torch.lexicon.pinyin import PinYin
from poccala_tpu_torch.lexicon.lexicon import PronunciationLexicon, FlatLexicon

__all__ = ["PinYin", "PronunciationLexicon", "FlatLexicon"]
