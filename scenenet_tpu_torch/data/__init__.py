"""Host data layer: point-cloud geometry, the TS40K and SemanticKITTI
datasets and their ETL, the transforms, the batch loaders (the native one
among them) and the device-resident caches. Exports what
:mod:`scenenet_tpu.data` exports."""

from scenenet_tpu_torch.data.pcd import (
    DICT_NEW_LABELS,
    POWER_LINE_SUPPORT_TOWER,
    select_object,
    extract_towers,
    crop_tower_radius,
    crop_two_towers,
    crop_ground_samples,
    crop_tower_samples,
    crop_at_locations,
    normalize_xyz,
    xyz_centroid,
    downsampling,
    downsampling_relative_height,
)
from scenenet_tpu_torch.data.cache import CachedDataset
from scenenet_tpu_torch.data.transforms import (
    AddPad,
    Compose,
    Jitter,
    PointPadding,
    RandomFlip,
    RandomRotateZ,
    ToFullDense,
    Voxelization,
    XYZToFullDense,
    XYZVoxelization,
)
from scenenet_tpu_torch.data.ts40k import TS40K, build_data_samples
from scenenet_tpu_torch.data.semantic_kitti import (
    SemanticKITTI, SemanticKITTICrops, build_pole_radius_samples,
)
from scenenet_tpu_torch.data.loader import (
    NativePointCloudLoader, PointCloudLoader, Subset, VoxelLoader, random_split,
)
from scenenet_tpu_torch.data.device_cache import (
    CacheLoader,
    DeviceGridCache,
    DevicePointCache,
    d4_transform_grids,
)

__all__ = [
    "DICT_NEW_LABELS",
    "POWER_LINE_SUPPORT_TOWER",
    "select_object",
    "extract_towers",
    "crop_tower_radius",
    "crop_two_towers",
    "crop_ground_samples",
    "crop_tower_samples",
    "crop_at_locations",
    "normalize_xyz",
    "xyz_centroid",
    "downsampling",
    "downsampling_relative_height",
    "AddPad",
    "CachedDataset",
    "Compose",
    "Jitter",
    "RandomFlip",
    "RandomRotateZ",
    "Voxelization",
    "XYZToFullDense",
    "XYZVoxelization",
    "ToFullDense",
    "PointPadding",
    "TS40K",
    "build_data_samples",
    "SemanticKITTI",
    "SemanticKITTICrops",
    "build_pole_radius_samples",
    "VoxelLoader",
    "NativePointCloudLoader",
    "CacheLoader",
    "DeviceGridCache",
    "DevicePointCache",
    "d4_transform_grids",
    "PointCloudLoader",
    "Subset",
    "random_split",
]
