"""The domain errors the ported slices raise (the classes of
``poccala_tpu/utils/errors.py``; that module's package imports jax)."""

from __future__ import annotations


class PoccalaError(Exception):
    """Base class for all framework errors."""


class UnitFileError(PoccalaError):
    """Unit inventory file missing/malformed (ref UnitFileExistsError)."""


class ParameterFileError(PoccalaError):
    """Checkpoint missing or corrupt (ref ParameterFileExistsError)."""


class ModeError(PoccalaError):
    """Unknown training scheme; valid schemes are 1 and 2 (ref ModeError)."""
