"""nerface-tpu's PyTorch / CUDA port, for one NVIDIA H100.

The JAX package `nerface_tpu` is the reference and stays as it is. This
package mirrors its module names (`config`, `data`, `ops`, `models`,
`render`, `eval`, `train`, `serve`, `cli`) and imports torch, never jax.
The first slice ported is the avatar server's render path:
`cli/serve.py` → `serve.AvatarServer` → `eval/renderer.render_full_frame`
→ `render/pipeline.render_rays` → `ops/kernels/fused_mlp.fused_paper_render`,
whose kernel is hand-written CUDA for sm_90a (`csrc/`). Importing the
package imports nothing heavy: modules are imported where used.
"""
