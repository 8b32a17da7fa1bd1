from inklayer_tpu_torch.models.depth.dpt import (DepthAnythingV2,
                                                 DepthEstimator, depth_bucket)

__all__ = ["DepthAnythingV2", "DepthEstimator", "depth_bucket"]
