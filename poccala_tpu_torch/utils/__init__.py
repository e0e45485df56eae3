"""Utility tier: log-domain constants and helpers, errors, logging."""
