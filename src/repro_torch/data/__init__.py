"""Synthetic collections (a copy of the reference's NumPy-only module)."""
