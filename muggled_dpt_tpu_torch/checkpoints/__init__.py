"""Checkpoint conversion: original torch state dicts -> this package's modules."""
