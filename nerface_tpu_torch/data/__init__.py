from nerface_tpu_torch.data.flame import FlameDataset, load_flame_data, pose_spherical
from nerface_tpu_torch.data.synthetic import make_synthetic_flame_dataset, synthetic_flame_dataset

__all__ = [
    "FlameDataset",
    "load_flame_data",
    "make_synthetic_flame_dataset",
    "pose_spherical",
    "synthetic_flame_dataset",
]
