"""Decoding over the ASR model."""
