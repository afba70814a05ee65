"""SpeechT5 ASR: speech encoder (prenet + relative-position transformer),
text decoder and vocabulary head."""

from .config import SpeechT5Config, tiny_config

__all__ = ["SpeechT5Config", "tiny_config"]
