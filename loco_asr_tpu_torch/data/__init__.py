"""SLURP adapter and embedding store (numpy, no device code)."""
