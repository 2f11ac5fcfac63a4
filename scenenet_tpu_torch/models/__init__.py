"""Models."""

from scenenet_tpu_torch.models.scenenet import SceneNet

__all__ = ["SceneNet"]
