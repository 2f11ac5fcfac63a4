"""Models."""

from scenenet_tpu_torch.models.cnn_baseline import CnnBaseline, CnnBaseline2
from scenenet_tpu_torch.models.nnunet3d import NNUNet3D
from scenenet_tpu_torch.models.scenenet import (
    GENEONet, QuantileSceneNet, SceneNet, SceneNetClassifier,
)
from scenenet_tpu_torch.models.unet3d import UNet3D

__all__ = ["CnnBaseline", "CnnBaseline2", "GENEONet", "NNUNet3D", "QuantileSceneNet", "SceneNet",
           "SceneNetClassifier", "UNet3D"]
