"""Phonetic question set for Mandarin pinyin units.

BASELINE config 3's "tied-state triphone-style units" convention is
decision-tree state tying driven by phonetic questions (the HTK
``QS``/``TB`` recipe).  The reference has no tying at all — its unit
inventory is the flat pinyin initial/final set
(``AcousticModel.py:151-161`` loads it from the unit
file) — so the question set here is derived from the standard Mandarin
phonology of that same inventory (``poccala_tpu_torch.io.corpus.INITIALS`` /
``ZERO_INITIALS`` / ``FINALS``), not from any reference code.

A *question* is a named predicate over acoustic-unit names; the tree
builder (:func:`poccala_tpu_torch.models.tying.tie_by_tree`) asks each
question of the unit that owns a senone and splits the senone set by
the yes/no answer.  Tone digits (``a1`` … ``a4``, ``a0``/``a5``) are
stripped before base-class lookup and addressed by dedicated tone
questions, so one question set serves the IF, XIF and XIF_tone
inventories.
"""

from __future__ import annotations

from dataclasses import dataclass


def split_tone(unit: str) -> tuple[str, str | None]:
    """``"ang3" -> ("ang", "3")``; tone ``5`` normalizes to ``0``
    (neutral) as in :meth:`poccala_tpu_torch.lexicon.pinyin.PinYin`."""
    if unit and unit[-1].isdigit():
        tone = unit[-1]
        return unit[:-1], ("0" if tone == "5" else tone)
    return unit, None


# --- base-class membership (unit names with tones stripped) -----------
_STOPS = {"b", "p", "d", "t", "g", "k"}
_ASPIRATED = {"p", "t", "k", "q", "ch", "c"}
_FRICATIVES = {"f", "h", "x", "sh", "s", "r"}
_AFFRICATES = {"j", "q", "zh", "ch", "z", "c"}
_NASAL_INITIALS = {"m", "n"}
_LABIALS = {"b", "p", "m", "f"}
_ALVEOLARS = {"d", "t", "n", "l", "z", "c", "s"}
_RETROFLEXES = {"zh", "ch", "sh", "r"}
_PALATALS = {"j", "q", "x"}
_VELARS = {"g", "k", "h"}
_VOICED_INITIALS = {"m", "n", "l", "r"}
_SIBILANTS = {"z", "c", "s", "zh", "ch", "sh", "j", "q", "x"}

_MEDIAL_I = {"i", "ia", "ie", "iao", "iu", "ian", "iang", "in", "ing",
             "iong"}
_MEDIAL_U = {"u", "ua", "uo", "uai", "ui", "uan", "uang", "un"}
_MEDIAL_V = {"v", "ve", "vn", "ue"}
_N_CODA = {"an", "en", "in", "un", "vn", "ian", "uan"}
_NG_CODA = {"ang", "eng", "ing", "ong", "iang", "iong", "uang"}
_DIPHTHONGS = {"ai", "ei", "ao", "ou", "ia", "ie", "iao", "iu",
               "ua", "uo", "uai", "ui", "ue", "ve"}
_A_NUCLEUS = {"a", "ai", "ao", "an", "ang", "ia", "iao", "ian", "iang",
              "ua", "uai", "uan", "uang"}
_E_NUCLEUS = {"e", "ei", "en", "eng", "er", "ie", "ue", "ve", "ui"}
_O_NUCLEUS = {"o", "ou", "ong", "uo", "iong"}
_HIGH_NUCLEUS = {"i", "u", "v", "in", "un", "vn", "ing", "iu"}


def _is_zero_initial(base: str) -> bool:
    return base.startswith("#")


def _is_final(base: str) -> bool:
    return not base.startswith("#") and (
        base[0] in "aoeiuv" or base == "er")


@dataclass(frozen=True)
class Question:
    """A named yes-set over unit ids for one inventory."""

    name: str
    members: frozenset  # unit ids answering "yes"

    def __repr__(self):
        return f"Question({self.name!r}, {len(self.members)} units)"


_BASE_CLASSES: list[tuple[str, set[str]]] = [
    ("stop", _STOPS),
    ("aspirated", _ASPIRATED),
    ("fricative", _FRICATIVES),
    ("affricate", _AFFRICATES),
    ("nasal_initial", _NASAL_INITIALS),
    ("lateral", {"l"}),
    ("labial", _LABIALS),
    ("alveolar", _ALVEOLARS),
    ("retroflex", _RETROFLEXES),
    ("palatal", _PALATALS),
    ("velar", _VELARS),
    ("voiced_initial", _VOICED_INITIALS),
    ("sibilant", _SIBILANTS),
    ("medial_i", _MEDIAL_I),
    ("medial_u", _MEDIAL_U),
    ("medial_v", _MEDIAL_V),
    ("n_coda", _N_CODA),
    ("ng_coda", _NG_CODA),
    ("nasal_coda", _N_CODA | _NG_CODA),
    ("diphthong", _DIPHTHONGS),
    ("a_nucleus", _A_NUCLEUS),
    ("e_nucleus", _E_NUCLEUS),
    ("o_nucleus", _O_NUCLEUS),
    ("high_nucleus", _HIGH_NUCLEUS),
    ("rhotic", {"er"}),
]

_TONE_CLASSES: list[tuple[str, set[str]]] = [
    ("tone_1", {"1"}),
    ("tone_2", {"2"}),
    ("tone_3", {"3"}),
    ("tone_4", {"4"}),
    ("tone_neutral", {"0"}),
    ("tone_high_onset", {"1", "4"}),   # start high
    ("tone_rising", {"2", "3"}),       # rise (3 = dip-rise)
]


def default_questions(units: list[str]) -> list[Question]:
    """Build the question list for a concrete unit inventory.

    Includes structural questions (is-final, is-zero-initial,
    per-initial / per-final-base identity), broad phonetic classes, and
    tone classes (only when the inventory is toned).  Questions whose
    yes-set is empty or covers the whole inventory are dropped — they
    can never split a node.
    """
    n = len(units)
    bases = []
    tones = []
    for u in units:
        b, t = split_tone(u)
        bases.append(b)
        tones.append(t)

    raw: list[tuple[str, set[int]]] = []
    raw.append(("final", {i for i in range(n) if _is_final(bases[i])}))
    raw.append(("zero_initial",
                {i for i in range(n) if _is_zero_initial(bases[i])}))
    for name, cls in _BASE_CLASSES:
        raw.append((name, {i for i in range(n) if bases[i] in cls}))
    for name, cls in _TONE_CLASSES:
        raw.append((name, {i for i in range(n) if tones[i] in cls}))
    # identity questions: every distinct base is its own (finest) class,
    # so the tree can always reach fully-untied leaves when the data
    # demands it
    for b in sorted(set(bases)):
        raw.append((f"is_{b}", {i for i in range(n) if bases[i] == b}))

    out, seen = [], set()
    for name, yes in raw:
        if not yes or len(yes) == n:
            continue
        key = frozenset(yes)
        if key in seen or frozenset(range(n)) - key in seen:
            continue
        seen.add(key)
        out.append(Question(name, key))
    return out
