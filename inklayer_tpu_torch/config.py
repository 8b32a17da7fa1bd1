"""Configuration of the port (the default run: detect, segment, clean,
NMS, depth, refine; and the inpainting stage).

The sections of :mod:`inklayer_tpu.config` that the port runs, with the
same field names and defaults, so a JSON file written by the JAX package's
``save_config`` loads here too.  Sections of stages that are not ported
yet (parallel) and top-level options the port does not read (among them
``inpaint``, which neither package reads: the CLI flag decides) are
ignored on load.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


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


@dataclass(frozen=True)
class DiffusionConfig:
    """SD1.5-inpaint + ControlNet v11p-inpaint stage: 768^2, 30
    DPM-Solver++(2M) steps, CFG 9.0, ControlNet scale 1.2, seed 3, two
    passes, the reference's prompt strings."""

    resolution: int = 768
    num_steps: int = 30
    guidance_scale: float = 9.0
    controlnet_scale: float = 1.2
    seed: int = 3
    num_passes: int = 2
    prompt: str = (
        "high quality black and white line drawing, clean precise lines, "
        "detailed sketch, professional illustration, sharp edges"
    )
    negative_prompt: str = (
        "blurry, smudged, messy lines, low quality, artifacts, noise, "
        "distorted, pixelated"
    )
    # single-layer web edit: the user's prompt, the same negative, cfg 7.0,
    # cond 0.6, one pass
    single_layer_guidance_scale: float = 7.0
    single_layer_controlnet_scale: float = 0.6
    single_layer_negative_prompt: str = (
        "blurry, smudged, messy lines, low quality, artifacts, noise, "
        "distorted, pixelated"
    )
    unet_block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    unet_layers_per_block: int = 2
    unet_attention_head_dim: int = 8
    cross_attention_dim: int = 768
    latent_channels: int = 4
    vae_channels: tuple[int, ...] = (128, 256, 512, 512)
    text_maxlen: int = 77


@dataclass(frozen=True)
class RefineConfig:
    """Classical refinement constants (cleaning, sketch NMS, depth sort,
    refiner), faithful to the reference values."""

    clean_threshold: int = 127
    clean_kernel_frac: float = 0.025
    min_cc_area: int = 500
    min_cc_aspect: float = 1.1
    nms_iou: float = 0.2
    nms_bbox_iou_kill: float = 0.7
    nms_eps_px_per_kdiag: float = 8.0
    nms_max_contained: int = 5
    nms_max_area_frac: float = 0.9
    ink_threshold: int = 250
    sample_radius_frac: float = 0.01
    depth_bin: float = 0.1
    containment_eps_frac: float = 0.002
    containment_area_gap: float = 0.02
    overlap_major_frac: float = 0.6
    max_ink_cover_frac: float = 0.9
    fragment_merge_frac: float = 0.05
    watershed_iters: int = 256
    distance_iters: int = 64


@dataclass(frozen=True)
class PipelineConfig:
    gdino: GDinoConfig = field(default_factory=GDinoConfig)
    sam: SamConfig = field(default_factory=SamConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    # run_dir worker threads, each on its own CUDA stream.  The JAX package
    # defaults to 4, measured on its TPU transport.  On the H100 more
    # workers lose (chip_smoke.py phase 7; PERF.md section 5): the refine
    # stage's eager loops share one interpreter lock.  So the port runs
    # one (ROADMAP section 3).
    sweep_workers: int = 1
    # queue the masks over the whole top-K capacity, their cleaning and the
    # device NMS front before the detect read-back, and read the detection
    # and the front back together (pipeline/refine/front.py
    # nms_depth_front_device).  Off by default, as in the JAX package; a
    # default for the card waits for a measured cell (ROADMAP section 1).
    device_front: bool = False


def to_jsonable(obj: Any) -> Any:
    """A config dataclass as ``json.dump`` input (the JAX package's
    ``_to_jsonable``): sections become dicts, tuples lists."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    return obj


def _from_jsonable(cls: type, data: dict) -> Any:
    """Rebuild a dataclass from ``json.load`` output: nested sections
    recurse, lists become tuples, unknown keys are ignored."""
    kwargs = {}
    types = {f.name: f.type for f in dataclasses.fields(cls)}
    for name, value in data.items():
        if name not in types:
            continue
        sub = _SECTIONS.get(types[name])
        if sub is not None:
            kwargs[name] = _from_jsonable(sub, value)
        elif isinstance(value, list):
            kwargs[name] = tuple(tuple(x) if isinstance(x, list) else x
                                 for x in value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


# field annotations are strings under ``from __future__ import annotations``
_SECTIONS = {c.__name__: c for c in (SwinConfig, BertConfig, GDinoConfig,
                                     SamConfig, DepthConfig, DiffusionConfig,
                                     RefineConfig)}


def load_config(path: str) -> PipelineConfig:
    """A JSON pipeline config (the JAX package's ``save_config`` format)."""
    with open(path) as f:
        return _from_jsonable(PipelineConfig, json.load(f))
