"""GPT-2 language model (full-sequence forward, token scoring, weight
bridges)."""

from .model import PRESETS, GPT2Config, tiny_gpt2_config

__all__ = ["GPT2Config", "PRESETS", "tiny_gpt2_config"]
