"""Model configuration: the same dataclasses and factories as
``dots_ocr_tpu.models.config``, with a torch dtype in place of ``jax_dtype``.

Flagship defaults are the published dots.ocr shapes: a 42-block NaViT vision
encoder (width 1536, 12 heads x 128, 2x2 merge) and a Qwen2.5-1.5B decoder
(28 layers, width 1536, GQA 12q/2kv x 128, vocab 151,936, tied embeddings).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class VisionConfig:
    """NaViT-style variable-resolution vision encoder."""

    hidden_size: int = 1536
    num_layers: int = 42
    num_heads: int = 12
    head_dim: int = 128
    intermediate_size: int = 4224
    patch_size: int = 14
    temporal_patch_size: int = 1
    spatial_merge_size: int = 2
    in_channels: int = 3
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    post_norm: bool = True
    qkv_bias: bool = True
    # 0 = image-wide attention in every layer. >0 = windowed attention over
    # window_size x window_size raw-patch tiles (a multiple of
    # spatial_merge_size), packed window-major with every window padded to
    # window_size^2 tokens; layers in full_attn_layers stay image-wide.
    window_size: int = 0
    full_attn_layers: tuple = ()
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_dim(self) -> int:
        return self.hidden_size * self.spatial_merge_size**2


@dataclass(frozen=True)
class DecoderConfig:
    """Qwen2.5-style causal decoder with GQA."""

    vocab_size: int = 151936
    hidden_size: int = 1536
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    head_dim: int = 128
    intermediate_size: int = 8960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    qkv_bias: bool = True
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 131072

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class SpecialTokens:
    """Token ids for chat structure and the image span (Qwen2.5 family)."""

    eos_token_id: int = 151645
    pad_token_id: int = 151643
    im_start_id: int = 151644
    im_end_id: int = 151645
    img_id: int = 151665
    imgpad_id: int = 151666
    endofimg_id: int = 151667


@dataclass(frozen=True)
class DotsOCRConfig:
    """Full VLM: vision encoder -> 2x2 merger/projector -> causal decoder."""

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    special: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kwargs) -> "DotsOCRConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def flagship() -> "DotsOCRConfig":
        """The ~3B production model (1.2B ViT + Qwen2.5-1.5B decoder)."""
        return DotsOCRConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "DotsOCRConfig":
        """A structurally identical miniature for CPU tests."""
        return DotsOCRConfig(
            vision=VisionConfig(
                hidden_size=32,
                num_layers=2,
                num_heads=2,
                head_dim=16,
                intermediate_size=64,
            ),
            decoder=DecoderConfig(
                vocab_size=vocab_size,
                hidden_size=64,
                num_layers=2,
                num_heads=4,
                num_kv_heads=2,
                head_dim=16,
                intermediate_size=128,
            ),
            special=SpecialTokens(
                eos_token_id=vocab_size - 1,
                pad_token_id=0,
                im_start_id=vocab_size - 2,
                im_end_id=vocab_size - 1,
                img_id=vocab_size - 5,
                imgpad_id=vocab_size - 4,
                endofimg_id=vocab_size - 3,
            ),
            dtype="float32",
        )

    @staticmethod
    def small(vocab_size: int = 32000) -> "DotsOCRConfig":
        """A mid-size config for single-chip experiments."""
        return DotsOCRConfig(
            vision=VisionConfig(hidden_size=512, num_layers=8, num_heads=8, head_dim=64,
                                intermediate_size=1408),
            decoder=DecoderConfig(
                vocab_size=vocab_size,
                hidden_size=1024,
                num_layers=12,
                num_heads=16,
                num_kv_heads=4,
                head_dim=64,
                intermediate_size=2816,
            ),
        )
