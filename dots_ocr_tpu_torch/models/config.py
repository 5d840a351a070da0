"""Model configuration: the same dataclasses and factories as
``dots_ocr_tpu.models.config``, with a torch dtype in place of ``jax_dtype``.

Flagship defaults are the published dots.ocr shapes: a 42-block NaViT vision
encoder (width 1536, 12 heads x 128, 2x2 merge) and a Qwen2.5-1.5B decoder
(28 layers, width 1536, GQA 12q/2kv x 128, vocab 151,936, tied embeddings).

``DeepseekDecoderConfig`` (a ``DecoderConfig`` whose ``deepseek`` is set;
None for dots.ocr) makes the decoder DeepSeek-V3's, as dots.vlm1 runs it:
latent attention (MLA) over a paged latent cache, leading dense layers, then
mixture-of-experts layers of which this device holds ``experts_held``, and
YaRN rope on the rope dims.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

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
class YarnRope:
    """DeepSeek's YaRN scaling of the rope frequencies (``rope_scaling`` of
    its config.json, ``type`` "yarn")."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


def yarn_get_mscale(scale: float, mscale: float) -> float:
    """DeepSeek's ``yarn_get_mscale``: 0.1 mscale ln(scale) + 1 above scale 1."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


@dataclass(frozen=True)
class DeepseekConfig:
    """DeepSeek-V3's decoder block, the keys of its config.json.

    Attention is MLA: ``q = q_b(RMSNorm(q_a(x)))`` split per head into
    ``qk_nope_head_dim`` + ``qk_rope_head_dim``; ``kv_a(x)`` gives the
    ``kv_lora_rank`` latent (RMS-normed) and one shared rope key; ``kv_b``
    expands the latent into each head's nope key and ``v_head_dim`` value.
    Layers from ``first_k_dense_replace`` on are MoE: a float32 sigmoid
    router over ``n_routed_experts`` experts (``noaux_tc``: a correction
    bias for the choice only, the best ``topk_group`` of ``n_group`` groups
    by the sum of their top two, top ``num_experts_per_tok``), plus
    ``n_shared_experts`` always-on experts. ``experts_held`` (first, count)
    are the routed experts this device holds (expert parallelism): it
    routes over all of them and computes its own experts' part."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 3
    moe_intermediate_size: int = 2048
    n_routed_experts: int = 256
    experts_held: Tuple[int, int] = (0, 256)
    num_experts_per_tok: int = 8
    n_group: int = 8
    topk_group: int = 4
    routed_scaling_factor: float = 2.5
    norm_topk_prob: bool = True
    n_shared_experts: int = 1
    rope_scaling: Optional[YarnRope] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token holds in the latent cache: the latent and the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """qk_head_dim^-0.5, times YaRN's mscale(factor, mscale_all_dim)^2."""
        scale = self.qk_head_dim ** -0.5
        y = self.rope_scaling
        if y is not None and y.mscale_all_dim:
            scale *= yarn_get_mscale(y.factor, y.mscale_all_dim) ** 2
        return scale


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
    # DeepSeek-V3's block keys (DeepseekDecoderConfig's field); a plain class
    # attribute here, so that dots.ocr's config keeps its fields
    deepseek = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class DeepseekDecoderConfig(DecoderConfig):
    """The decoder with DeepSeek-V3's block (``deepseek``): ``num_heads`` its
    attention heads, ``intermediate_size`` its dense layers' width."""

    deepseek: DeepseekConfig = dataclasses.field(default_factory=DeepseekConfig)


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
