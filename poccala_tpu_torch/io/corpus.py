"""Unit inventories (the part of ``poccala_tpu/io/corpus.py`` the decode
slice needs: ``standard_inventory`` and ``UnitInventory``, copied as host
code because that module imports the JAX frontend;
``tests/test_torch_lexicon.py`` pins the copy to the original).

The standard Mandarin IF / XIF / XIF_tone phone sets and the reference's
unit-file format (header line + comma-separated unit rows,
``AcousticModel.load_unit``, ``AcousticModel.py:134-162``).  Corpus
scanning, label parsing and batching wait for the training port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from poccala_tpu_torch.utils.errors import UnitFileError

# Standard Mandarin pinyin phone sets (the linguistic inventories behind
# the reference's AcousticModel/Unit/{IF,XIF,XIF_tone} files).
INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "z", "c", "s", "r",
]
ZERO_INITIALS = ["#_a", "#_o", "#_e", "#_I", "#_u", "#_v"]
FINALS = [
    "a", "o", "e", "i", "u", "v", "ai", "ei", "ao", "ou", "er",
    "an", "en", "in", "un", "vn", "ang", "eng", "ing", "ong",
    "ia", "ie", "iao", "iu", "ian", "iang", "iong",
    "ua", "uo", "uai", "ui", "uan", "uang", "ue", "ve",
]
TONES = ["0", "1", "2", "3", "4"]


def standard_inventory(kind: str = "XIF_tone") -> list[str]:
    """Programmatic IF / XIF / XIF_tone unit inventories."""
    if kind == "IF":
        return INITIALS + ["#"] + FINALS
    if kind == "XIF":
        return INITIALS + ZERO_INITIALS + FINALS
    if kind == "XIF_tone":
        finals = [f + t for f in FINALS for t in TONES]
        return INITIALS + ZERO_INITIALS + finals
    raise UnitFileError(f"unknown inventory kind: {kind!r}")


@dataclass
class UnitInventory:
    """Unit set with name<->id maps (the ``loaded_units`` list plus the
    senone indexing scheme of the bank)."""

    units: list[str]

    def __post_init__(self):
        self.id_of = {u: i for i, u in enumerate(self.units)}

    def __len__(self):
        return len(self.units)

    @classmethod
    def from_file(cls, path: str) -> "UnitInventory":
        """Parse the reference unit-file format: one header line, then
        comma-separated unit rows (``AcousticModel.py:151-161``)."""
        if not os.path.exists(path):
            raise UnitFileError(f"unit file not found: {path}")
        units: list[str] = []
        with open(path) as f:
            f.readline()  # header
            for line in f:
                line = line.strip("\n")
                if not line:
                    continue
                units.extend(u for u in line.split(",") if u)
        return cls(units)

    @classmethod
    def standard(cls, kind: str = "XIF_tone") -> "UnitInventory":
        return cls(standard_inventory(kind))

    def save(self, path: str, header: str = "units") -> None:
        with open(path, "w") as f:
            f.write(header + "\n")
            f.write(",".join(self.units) + "\n")

    def encode(self, names: list[str]) -> list[int]:
        return [self.id_of[n] for n in names]
