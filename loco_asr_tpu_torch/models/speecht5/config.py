"""SpeechT5 model configuration.

Field names and defaults mirror the public SpeechT5 architecture
(microsoft/speecht5_asr & microsoft/speecht5_tts checkpoints) so HF
checkpoints import without shape surgery.  Every in-file constant of the
reference becomes a config field here (SURVEY.md §5 config row).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SpeechT5Config:
    vocab_size: int = 81
    hidden_size: int = 768
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    decoder_layers: int = 6
    decoder_attention_heads: int = 12
    decoder_ffn_dim: int = 3072
    hidden_act: str = "gelu"
    positional_dropout: float = 0.1
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    scale_embedding: bool = False
    # speech prenet (wav2vec2-style conv feature encoder)
    feat_extract_norm: str = "group"
    feat_proj_dropout: float = 0.0
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0
    # positions
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    max_speech_positions: int = 4000
    max_text_positions: int = 450
    encoder_max_relative_position: int = 160
    # speech decoder pre/post nets (TTS side)
    speech_decoder_prenet_layers: int = 2
    speech_decoder_prenet_units: int = 256
    speech_decoder_prenet_dropout: float = 0.5
    speaker_embedding_dim: int = 512
    speech_decoder_postnet_layers: int = 5
    speech_decoder_postnet_units: int = 256
    speech_decoder_postnet_kernel: int = 5
    speech_decoder_postnet_dropout: float = 0.5
    num_mel_bins: int = 80
    reduction_factor: int = 2
    use_guided_attention_loss: bool = True
    guided_attention_loss_num_heads: int = 2
    guided_attention_loss_sigma: float = 0.4
    guided_attention_loss_scale: float = 10.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.encoder_attention_heads

    def feat_extract_output_length(self, input_length: int) -> int:
        """Frames produced by the conv feature encoder for a waveform length
        (torch Conv1d floor formula; reference behavior via HF
        _get_feat_extract_output_lengths)."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            input_length = (input_length - k) // s + 1
        return input_length


def tiny_config(**overrides) -> SpeechT5Config:
    """Small config for unit tests (CPU-fast, same code paths)."""
    base = dict(
        vocab_size=37,
        hidden_size=24,
        encoder_layers=2,
        encoder_attention_heads=2,
        encoder_ffn_dim=48,
        decoder_layers=2,
        decoder_attention_heads=2,
        decoder_ffn_dim=48,
        conv_dim=(16, 16),
        conv_stride=(5, 2),
        conv_kernel=(10, 3),
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        max_speech_positions=256,
        max_text_positions=64,
        encoder_max_relative_position=20,
        speech_decoder_prenet_units=16,
        speech_decoder_postnet_units=16,
        num_mel_bins=8,
        speaker_embedding_dim=12,
    )
    base.update(overrides)
    return SpeechT5Config(**base)
