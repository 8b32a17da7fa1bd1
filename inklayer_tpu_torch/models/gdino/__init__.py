from inklayer_tpu_torch.models.gdino.gdino import (GDinoDetector, GroundingDINO,
                                                   top_detections)

__all__ = ["GDinoDetector", "GroundingDINO", "top_detections"]
