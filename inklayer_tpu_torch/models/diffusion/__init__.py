"""SD1.5-inpaint + ControlNet diffusion stage (port of
:mod:`inklayer_tpu.models.diffusion`, SDXL not ported)."""

from inklayer_tpu_torch.models.diffusion.clip_text import (CLIPTextEncoder,
                                                           CLIPTokenizer)
from inklayer_tpu_torch.models.diffusion.controlnet import ControlNet
from inklayer_tpu_torch.models.diffusion.pipeline import \
    ControlNetInpaintPipeline
from inklayer_tpu_torch.models.diffusion.scheduler import (
    DPMSolverMultistepScheduler, solver_tables)
from inklayer_tpu_torch.models.diffusion.unet import UNet2DCondition
from inklayer_tpu_torch.models.diffusion.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "CLIPTextEncoder", "CLIPTokenizer", "ControlNet",
           "ControlNetInpaintPipeline", "DPMSolverMultistepScheduler",
           "UNet2DCondition", "solver_tables"]
