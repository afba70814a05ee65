"""SpeechT5: the ASR model (speech encoder: prenet + relative-position
transformer; text decoder; vocabulary head), the TTS and voice-conversion
models (text or speech encoder, speech decoder, speech postnet) and the
HiFi-GAN vocoder."""

from .config import SpeechT5Config, tiny_config
from .model import (S2sModel, TtsModel, encode_text, s2s_forward, s2s_init,
                    shift_spectrograms_right, tts_forward, tts_generate,
                    tts_init)
from .vocoder import HifiGan, HifiGanConfig, hifigan, hifigan_init, tiny_hifigan_config

__all__ = ["SpeechT5Config", "tiny_config", "TtsModel", "S2sModel", "tts_init",
           "s2s_init", "encode_text", "tts_forward", "s2s_forward",
           "shift_spectrograms_right", "tts_generate", "HifiGanConfig",
           "tiny_hifigan_config", "HifiGan", "hifigan_init", "hifigan"]
