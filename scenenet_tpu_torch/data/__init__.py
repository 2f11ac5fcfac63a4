"""Host data layer: the TS40K crops, point padding and batch loaders."""

from scenenet_tpu_torch.data.loader import PointCloudLoader, Subset, random_split
from scenenet_tpu_torch.data.transforms import PointPadding
from scenenet_tpu_torch.data.ts40k import TS40K

__all__ = ["PointCloudLoader", "PointPadding", "Subset", "TS40K", "random_split"]
