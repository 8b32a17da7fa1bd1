"""The configuration classes of the reference's models: the fields and
defaults of ``inklayer_tpu_torch.config`` for GroundingDINO, SAM
and Depth-Anything-V2.  The benchmark builds them from a configuration
file."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SwinConfig:
    """Swin-T backbone (GroundingDINO swin_T_224_1k)."""

    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_indices: tuple[int, ...] = (1, 2, 3)
    qkv_bias: bool = True
    in_chans: int = 3


@dataclass(frozen=True)
class BertConfig:
    """BERT-base text encoder (bert-base-uncased)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclass(frozen=True)
class GDinoConfig:
    """GroundingDINO SwinT-OGC."""

    hidden_dim: int = 256
    num_queries: int = 900
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    nheads: int = 8
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    max_text_len: int = 256
    pe_temperature_h: float = 20.0
    pe_temperature_w: float = 20.0
    two_stage: bool = True
    text_enhancer_nheads: int = 4
    text_enhancer_ffn: int = 1024
    fusion_embed_dim: int = 1024
    fusion_nheads: int = 4
    swin: SwinConfig = field(default_factory=SwinConfig)
    bert: BertConfig = field(default_factory=BertConfig)
    # inference-time thresholds
    box_threshold: float = 0.2
    text_threshold: float = 0.0
    caption: str = "object"
    # (H, W) buckets the image is padded into after an aspect-preserving
    # resize of the shorter side to 800, the longer capped at 1333
    resize_short: int = 800
    resize_max: int = 1333
    shape_buckets: tuple[tuple[int, int], ...] = (
        (800, 800),
        (800, 1066),
        (800, 1344),
        (1066, 800),
        (1344, 800),
    )
    max_boxes: int = 64  # the top-K detections chained into SAM


@dataclass(frozen=True)
class SamConfig:
    """SAM image encoder / prompt encoder / mask decoder; defaults ViT-H."""

    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: tuple[int, ...] = (7, 15, 23, 31)
    encoder_window_size: int = 14
    image_size: int = 1024
    patch_size: int = 16
    prompt_embed_dim: int = 256
    mask_threshold: float = 0.0
    pixel_mean: tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: tuple[float, float, float] = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class DepthConfig:
    """Depth-Anything-V2 (DINOv2 encoder + DPT head); defaults ViT-B."""

    encoder: str = "vitb"
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 14
    intermediate_layers: tuple[int, ...] = (2, 5, 8, 11)
    features: int = 128
    out_channels: tuple[int, ...] = (96, 192, 384, 768)
    input_size: int = 518  # resize lower bound, multiple of 14
    layerscale_init: float = 1.0
    interpolate_offset: float = 0.1
    # metric-depth variant: > 0 switches the head to sigmoid * max_depth
    max_depth: float = 0.0

    @staticmethod
    def vits() -> "DepthConfig":
        return DepthConfig(
            encoder="vits", embed_dim=384, num_heads=6, features=64,
            out_channels=(48, 96, 192, 384))

    @staticmethod
    def vitl() -> "DepthConfig":
        return DepthConfig(
            encoder="vitl", embed_dim=1024, depth=24, num_heads=16,
            intermediate_layers=(4, 11, 17, 23), features=256,
            out_channels=(256, 512, 1024, 1024))
