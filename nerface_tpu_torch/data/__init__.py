from nerface_tpu_torch.data.blender import BlenderDataset, load_blender_data
from nerface_tpu_torch.data.flame import FlameDataset, load_flame_data, pose_spherical
from nerface_tpu_torch.data.llff import LLFFDataset, load_llff_data
from nerface_tpu_torch.data.synthetic import make_synthetic_flame_dataset, synthetic_flame_dataset

__all__ = [
    "BlenderDataset",
    "load_blender_data",
    "LLFFDataset",
    "load_llff_data",
    "FlameDataset",
    "load_flame_data",
    "make_synthetic_flame_dataset",
    "pose_spherical",
    "synthetic_flame_dataset",
]
