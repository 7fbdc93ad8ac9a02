"""K2's 2-CTA cluster against single CTAs, on the card.

`csrc/fused_paper_render.cu` multicasts each weight chunk to the two CTAs
of a cluster, so a chunk leaves L2 once for 256 rows; built with
NERFACE_K2_CLUSTER=1 every CTA copies its own. This builds both, checks
that they give bit-identical outputs, and times them in turns (ABBA over
ROUNDS rounds) through the wrapper `fused_paper_render`:

- a 65536-ray tile at S = 64 (with weights) and at S = 128;
- a parity 512² frame's K2 work: FRAME_TILES tiles × (coarse + fine), the
  launches a served frame makes, back to back.

    python -m nerface_tpu_torch.tools.perf.k2_cluster_ablation

prints the card line, each variant's median ms and a JSON line.
"""

from __future__ import annotations

import contextlib
import json
import statistics

import torch

from nerface_tpu_torch.ops.kernels import build
from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.tools.perf.cases import ray_draws

TILE_RAYS = 65536
FRAME_TILES = 4
ROUNDS = 6
VARIANTS = {"cluster2": (), "cluster1": ("NERFACE_K2_CLUSTER=1",)}


@contextlib.contextmanager
def variant(defines):
    """K2's wrapper launches the library built with `defines` inside."""
    real = build.load_library

    def load(name="fused_paper_render", other=()):
        return real(name, tuple(defines) if name == "fused_paper_render" else other)

    build.load_library = load
    try:
        yield
    finally:
        build.load_library = real


def _inputs(n_rays, n_samples, seed, dev):
    g = torch.Generator().manual_seed(seed)
    ro, rd, z = ray_draws(n_rays, n_samples, g)
    dc = torch.randn(n_rays, 128, generator=g) * 0.3
    cond = torch.randn(108, generator=g) * 0.2
    bg = torch.rand(n_rays, 3, generator=g)
    return [t.to(dev).contiguous() for t in (ro, rd, z, dc, cond, bg)]


def run(dev, seed: int = 0):
    """Per variant: the median over ROUNDS of each case's median ms, and
    whether the two builds' outputs are bit-identical."""
    from nerface_tpu_torch.models.nerf_models import ConditionalBlendshapePaperNeRFModel
    from nerface_tpu_torch.tools.perf._timing import median_ms

    model = ConditionalBlendshapePaperNeRFModel(
        num_encoding_fn_xyz=10, num_encoding_fn_dir=4, include_input_dir=False, device=dev,
        generator=torch.Generator().manual_seed(seed))
    packed = K.pack_paper_weights(model.state_dict())
    passes = {}
    for label, S, with_w in (("coarse", 64, True), ("fine", 128, False)):
        ro, rd, z, dc, cond, bg = _inputs(TILE_RAYS, S, seed + S, dev)
        passes[label] = ((packed, ro, rd, z, dc, cond), dict(background=bg, out_weights=with_w))

    def tile(label):
        args, kw = passes[label]
        return K.fused_paper_render(*args, **kw)

    def frame():
        for _ in range(FRAME_TILES):
            tile("coarse")
            tile("fine")

    outs, times = {}, {v: {"coarse": [], "fine": [], "frame": []} for v in VARIANTS}
    for v, defines in VARIANTS.items():
        with variant(defines):
            outs[v] = {label: tile(label) for label in passes}
    torch.cuda.synchronize()
    a, b = (outs[v] for v in VARIANTS)
    identical = all(torch.equal(a[p][k], b[p][k]) for p in a for k in a[p])
    order = list(VARIANTS)
    for r in range(ROUNDS):
        for v in order if r % 2 == 0 else order[::-1]:
            with variant(VARIANTS[v]):
                for label in passes:
                    times[v][label].append(median_ms(lambda: tile(label), iters=10))
                times[v]["frame"].append(median_ms(frame, warmup=1, iters=5))
    return {"identical": identical, "rounds": ROUNDS,
            "ms": {v: {c: statistics.median(t) for c, t in cs.items()} for v, cs in times.items()},
            "all_ms": times}


def main() -> None:
    from nerface_tpu_torch.tools.perf._timing import card_line

    print(card_line())
    res = run(torch.device("cuda"))
    for v, cs in res["ms"].items():
        print(f"{v}: tile S=64 {cs['coarse']:.3f} ms, S=128 {cs['fine']:.3f} ms, a frame's K2 work "
              f"({FRAME_TILES} tiles × 2 passes) {cs['frame']:.3f} ms")
    print(f"bit-identical outputs: {res['identical']}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
