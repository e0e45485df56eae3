"""Domain-error taxonomy (a copy of ``poccala_tpu/utils/errors.py``).

Mirrors the reference's 13 exception classes (``Exceptions.py:12-148``)
with the same failure categories, minus the logging side effects (errors
here are plain exceptions; logging is the caller's job).
"""

from __future__ import annotations


class PoccalaError(Exception):
    """Base class for all framework errors."""


class MixtureNumberError(PoccalaError):
    """Initial mixture count exceeds the ceiling (ref ``Exceptions.py`` MixtureNumberError)."""

    def __init__(self, mix_level: int, max_mix_level: int):
        super().__init__(
            f"mix_level={mix_level} exceeds max_mix_level={max_mix_level}"
        )


class UnitFileError(PoccalaError):
    """Unit inventory file missing/malformed (ref UnitFileExistsError)."""


class ParameterFileError(PoccalaError):
    """Checkpoint missing or corrupt (ref ParameterFileExistsError)."""


class ConfigError(PoccalaError):
    """Configuration file missing or invalid (ref ConfigExitsError)."""


class DataUnloadedError(PoccalaError):
    """Operation requested before data was loaded (ref DataUnLoadError)."""


class DataDimensionError(PoccalaError):
    """Feature dimension mismatch (ref DataDimensionError)."""

    def __init__(self, expected: int, got: int):
        super().__init__(f"expected feature dim {expected}, got {got}")


class JobIdError(PoccalaError):
    """Machine/job id missing from the environment (ref JobIDExistError)."""


class PathInfoError(PoccalaError):
    """Data-shard path list missing (ref PathInfoExistError)."""


class ModeError(PoccalaError):
    """Unknown training scheme; valid schemes are 1 and 2 (ref ModeError)."""


class ClassError(PoccalaError):
    """Unknown algorithm selector (ref ClassError)."""


class AlignmentError(PoccalaError):
    """Viterbi alignment produced fewer units than the label — the
    utterance is discarded (ref ``AcousticModel.py:751-757``)."""
