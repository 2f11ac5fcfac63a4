"""Models."""

from scenenet_tpu_torch.models.scenenet import QuantileSceneNet, SceneNet

__all__ = ["QuantileSceneNet", "SceneNet"]
