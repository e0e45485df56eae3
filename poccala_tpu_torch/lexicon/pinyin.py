"""Hanzi → pinyin grapheme-to-phoneme conversion.

Host code copied from ``poccala_tpu/lexicon/pinyin.py`` (the JAX package's
import chain for it loads jax); ``tests/test_torch_lexicon.py`` pins the
copy to the original.

Reimplements the reference's ``Lexicon/PinYin.py:19-132`` semantics:

* dictionary lookup (polyphones return multiple readings);
* ``separate``: insert a comma between initial and final, recognizing
  two-character initials zh/ch/sh (``PinYin.py:93-100``);
* ``check_tone``: after j/q/x, ``u → v`` (unless ``iu``), and
  ``ue → ve`` everywhere (``PinYin.py:101-107``);
* ``extend``: zero-initial expansion — ``y → #_I``, ``w → #_u``, and
  vowel-initial syllables get the ``#_a/#_o/#_e/#_v`` pseudo-initial
  prepended (``PinYin.py:109-127``, ``__extend_dict`` at ``:26-37``);
* neutral tone 5 is rewritten to 0 (``PinYin.py:116-118``) — like the
  reference, only on the non-y/w branch.

Deviation (documented): the reference looks up its zero-initial extend
dict with the tone digit still attached when ``show_tone_mark=True``
(``PinYin.py:117-123``), so the documented vowel-initial expansion never
actually fires on the lexicon-generation path — a latent bug.  We strip
the tone digit before the lookup so ``an4 → #_a,an4`` works as intended.

The mapping table can come from (a) the built-in subset
(:mod:`poccala_tpu.lexicon.builtin_table`), (b) a reference-format
``Mandarin.dat`` (hex-codepoint TSV, one line per character), or (c) any
``{hanzi: [readings]}`` dict.
"""

from __future__ import annotations

import os

from poccala_tpu_torch.lexicon.builtin_table import BUILTIN_PINYIN

SYLLABLE_INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "j", "q", "x",
    "zh", "ch", "sh", "z", "c", "s", "r", "y", "w",
]  # y/w are listed though not true initials (PinYin.py:24-25)

EXTEND_DICT = {
    "ai": "#_a", "ao": "#_a", "an": "#_a", "ang": "#_a",
    "o": "#_o", "ou": "#_o",
    "e": "#_e", "ei": "#_e", "er": "#_e", "en": "#_e",
    "?": "#_v",
}  # PinYin.py:26-37


def load_mandarin_dat(path: str, lower: bool = True) -> dict[str, list[str]]:
    """Parse the reference's table format: ``<hex codepoint>\\t<P1 P2 …>``
    (``PinYin.__init_dict``, ``PinYin.py:39-56``)."""
    table: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip("\n")
            if not line:
                continue
            code, _, readings = line.partition("\t")
            char = chr(int(code, 16))
            items = readings.split(" ")
            if lower:
                items = [r.lower() for r in items]
            table[char] = items
    return table


class PinYin:
    def __init__(self, table: dict[str, list[str]] | str | None = None):
        """:param table: a dict, a path to a Mandarin.dat-format file, or
        None for the built-in subset."""
        if table is None:
            self._dict = dict(BUILTIN_PINYIN)
        elif isinstance(table, str):
            if not os.path.exists(table):
                raise FileNotFoundError(table)
            self._dict = load_mandarin_dat(table)
        else:
            self._dict = dict(table)

    def word2pinyin(
        self,
        string: str,
        separate: bool = True,
        check_tone: bool = True,
        extend: bool = True,
        show_tone_mark: bool = True,
    ) -> list[list[str]] | None:
        """Transliterate; returns per-character reading lists, or None if
        any character is unknown (``PinYin.py:58-80``)."""
        out = []
        for ch in string:
            readings = self._dict.get(ch)
            if readings is None:
                return None
            converted = [
                self._convert(r, separate, check_tone, extend, show_tone_mark)
                for r in readings
            ]
            if not show_tone_mark:
                # strip tones and dedup (PinYin.py:75-78)
                converted = sorted(set(converted))
            out.append(list(converted))
        return out

    # ------------------------------------------------------------------
    def _convert(self, tone: str, separate: bool, check_tone: bool,
                 extend: bool, show_tone_mark: bool) -> str:
        """Single-reading version of ``__check_tone`` (``PinYin.py:82-132``)."""
        if separate:
            if tone[0] in SYLLABLE_INITIALS:
                if len(tone) >= 3 and tone[:2] in SYLLABLE_INITIALS:
                    tone = tone[:2] + "," + tone[2:]
                else:
                    tone = tone[0] + "," + tone[1:]
        if check_tone:
            if tone[0] in ("j", "q", "x"):
                if "u" in tone and "iu" not in tone:
                    tone = tone.replace("u", "v")
            if "ue" in tone:
                tone = tone.replace("ue", "ve")
        if extend:
            if "y" in tone:
                tone = tone.replace("y", "#_I")
            elif "w" in tone:
                tone = tone.replace("w", "#_u")
            else:
                if show_tone_mark:
                    if tone[-1].isdigit() and int(tone[-1]) == 5:
                        tone = tone[:-1] + "0"
                    tone_tmp = tone
                else:
                    tone_tmp = tone[:-1] if tone[-1].isdigit() else tone
                key = tone_tmp.split(",")[-1]
                base = key[:-1] if (show_tone_mark and key and key[-1].isdigit()) else key
                if "," not in tone and EXTEND_DICT.get(base) is not None:
                    if separate:
                        tone = EXTEND_DICT[base] + "," + tone
                    else:
                        tone = EXTEND_DICT[base] + tone
        else:
            if tone and (tone[0] == "y" or tone[0] == "w"):
                tone = tone[1:]
        if not show_tone_mark and tone and tone[-1].isdigit():
            tone = tone[:-1]
        return tone

    def convert_syllable(self, syllable: str, separate: bool = True,
                         check_tone: bool = True, extend: bool = True,
                         show_tone_mark: bool = True) -> str:
        """Apply the transliteration transforms to a bare toned pinyin
        syllable (e.g. ``"lv4" -> "l,v4"``, ``"yi1" -> "#_I,i1"``) — the
        label alphabet of THCHS-30-style transcripts, which carry pinyin
        syllables rather than unit sequences."""
        return self._convert(syllable, separate, check_tone, extend,
                             show_tone_mark)

    def syllable_to_units(self, syllable: str) -> list[str]:
        """Toned pinyin syllable -> acoustic unit list, e.g.
        ``"zhong1" -> ["zh", "ong1"]``."""
        return self.convert_syllable(syllable).split(",")

    def units_of(self, string: str) -> list[list[list[str]]] | None:
        """Per-character unit sequences: each reading split into its
        ``[initial, final]`` (or ``[final]``) unit list — the decoder's
        label alphabet."""
        p = self.word2pinyin(string)
        if p is None:
            return None
        return [[r.split(",") for r in readings] for readings in p]
