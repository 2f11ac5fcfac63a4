"""Checkpoint compatibility with the reference: Lightning ``.ckpt`` and
legacy ``gnet.pt`` import, the inverse export, a model-zoo scan."""
from scenenet_tpu_torch.compat.torch_import import (
    load_lightning_checkpoint,
    load_legacy_state_dict,
    export_torch_state_dict,
    import_scenenet_params,
    scan_model_zoo,
)

__all__ = [
    "load_lightning_checkpoint",
    "load_legacy_state_dict",
    "export_torch_state_dict",
    "import_scenenet_params",
    "scan_model_zoo",
]
