"""Training tier (so far only checkpoint loading)."""
