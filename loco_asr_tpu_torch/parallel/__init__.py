"""Training steps (one device)."""
