"""Models (NCHW inside, the JAX package's NHWC at the outputs)."""

from rrnet_torch.models.build import build_backbone, build_model

__all__ = ["build_backbone", "build_model"]
