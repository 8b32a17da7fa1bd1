from inklayer_tpu_torch.models.sam.amg import SamAutomaticMaskGenerator
from inklayer_tpu_torch.models.sam.sam import Sam, SamPredictor

__all__ = ["Sam", "SamPredictor", "SamAutomaticMaskGenerator"]
