"""nerface-tpu's PyTorch / CUDA port, for one NVIDIA H100.

The JAX package `nerface_tpu` is the reference and stays as it is. This
package mirrors its module names (`config`, `data`, `ops`, `models`,
`render`, `eval`, `train`, `serve`, `cli`, `tools`, `client`) and imports
torch, never jax.
The first slice ported is the avatar server's render path:
`cli/serve.py` → `serve.AvatarServer` → `eval/renderer.render_full_frame`
→ `render/pipeline.render_rays` → `ops/kernels/fused_mlp.fused_paper_render`,
whose kernel is hand-written CUDA for sm_90a (`csrc/`). Importing the
package imports nothing heavy: modules are imported where used, and the
names the JAX package exports at its top level (`nerface_tpu/__init__.py`)
load on first access.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "CfgNode": "nerface_tpu_torch.config",
    "cumprod_exclusive": "nerface_tpu_torch.ops.math",
    "img2mse": "nerface_tpu_torch.ops.math",
    "meshgrid_xy": "nerface_tpu_torch.ops.math",
    "mse2psnr": "nerface_tpu_torch.ops.math",
    "get_embedding_function": "nerface_tpu_torch.ops.encoding",
    "positional_encoding": "nerface_tpu_torch.ops.encoding",
    "get_ray_bundle": "nerface_tpu_torch.ops.rays",
    "ndc_rays": "nerface_tpu_torch.ops.rays",
    "sample_pdf": "nerface_tpu_torch.ops.sampling",
    "volume_render_radiance_field": "nerface_tpu_torch.ops.compositing",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

