"""SpeechT5 speech encoder (prenet + relative-position transformer)."""

from .config import SpeechT5Config, tiny_config

__all__ = ["SpeechT5Config", "tiny_config"]
