"""Utility tier: log-domain math, structured logging, errors, profiling,
and the default device."""

from poccala_tpu_torch.utils.logmath import (
    LOG_2PI,
    NEG_INF,
    diag_gaussian_logpdf,
    log_matvec,
    logsumexp,
)

__all__ = [
    "LOG_2PI",
    "NEG_INF",
    "diag_gaussian_logpdf",
    "log_matvec",
    "logsumexp",
]
