"""Decoding over the ASR model: greedy and beam search with GPT-2 shallow
fusion (``beam``, ``fusion``), conversation carry-over (``context``),
continuous batching (``batcher``) and long-form transcription
(``long_audio``)."""

from .beam import BeamHypotheses, beam_search, greedy_decode
from .context import ConversationContext
from .fusion import FusionLM
from .long_audio import TranscribedSegment, transcribe_long_audio

__all__ = ["BeamHypotheses", "ConversationContext", "FusionLM", "TranscribedSegment",
           "beam_search", "greedy_decode", "transcribe_long_audio"]
