"""The domain errors the ported slice raises (the classes of
``poccala_tpu/utils/errors.py``; that module's package imports jax)."""

from __future__ import annotations


class PoccalaError(Exception):
    """Base class for all framework errors."""


class UnitFileError(PoccalaError):
    """Unit inventory file missing/malformed (ref UnitFileExistsError)."""


class ParameterFileError(PoccalaError):
    """Checkpoint missing or corrupt (ref ParameterFileExistsError)."""
