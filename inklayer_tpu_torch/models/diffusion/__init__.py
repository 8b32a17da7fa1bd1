"""The diffusion models (port of :mod:`inklayer_tpu.models.diffusion`):
the SD1.5-inpaint + ControlNet stage of ``--inpaint``, and the SDXL
inpainting backend (:mod:`.sdxl`: the SDXL UNet options, the CLIP-L and
OpenCLIP-bigG penultimate towers, ``SDXLInpaintPipeline.generate``)."""

from inklayer_tpu_torch.models.diffusion.clip_text import (CLIPTextEncoder,
                                                           CLIPTokenizer)
from inklayer_tpu_torch.models.diffusion.controlnet import ControlNet
from inklayer_tpu_torch.models.diffusion.pipeline import \
    ControlNetInpaintPipeline
from inklayer_tpu_torch.models.diffusion.scheduler import (
    DPMSolverMultistepScheduler, solver_tables)
from inklayer_tpu_torch.models.diffusion.sdxl import (CLIPTextTower,
                                                      SDXLConfig,
                                                      SDXLInpaintPipeline)
from inklayer_tpu_torch.models.diffusion.unet import UNet2DCondition
from inklayer_tpu_torch.models.diffusion.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "CLIPTextEncoder", "CLIPTextTower",
           "CLIPTokenizer", "ControlNet", "ControlNetInpaintPipeline",
           "DPMSolverMultistepScheduler", "SDXLConfig", "SDXLInpaintPipeline",
           "UNet2DCondition", "solver_tables"]
