"""Decoding over the ASR model: greedy and beam search with GPT-2 shallow
fusion (``beam``, ``fusion``), conversation carry-over (``context``) and
continuous batching (``batcher``)."""

from .beam import BeamHypotheses, beam_search, greedy_decode
from .context import ConversationContext
from .fusion import FusionLM

__all__ = ["BeamHypotheses", "ConversationContext", "FusionLM", "beam_search",
           "greedy_decode"]
