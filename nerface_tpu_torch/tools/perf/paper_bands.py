"""The paper kernels' bare launches at a given xyz band count, on the card:
K2 on a 65536-ray tile at S = 64 (with its weights) and at S = 128, and
K1's train step pair at 2048 rays (S = 64 + 128, σ-noise and a
background), each launch alone with its operands packed beforehand (K2
through `fused_mlp._launch_render`, K1 through `fused_train._launch_train`)
and timed by CUDA events (the median of ITERS after a warm-up), beside its
operations bound at the bf16 dense peak.

At 10 bands it calls only what every checkout of the port with the wgmma
kernels has, so it times two trees against each other: run it with PYTHONPATH at
each checkout's root, in turns (parent, change, change, parent), each
building its own libraries under its own build/. Past 10 bands (K = 128
encoding) it needs a checkout whose kernels take them. `--samples S ...`
adds K2's tile and K1's pass at each S (the runtime layout class, and past
256 a long item, which needs a checkout whose kernels take it).

    python -m nerface_tpu_torch.tools.perf.paper_bands [--bands L] [--samples S ...] [--json PATH]

It prints the card line, one line per case and a JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.tools.perf._timing import card_line, median_ms
from nerface_tpu_torch.tools.perf.cases import paper_case, paper_params, render_inputs

PEAK_BF16_FLOPS = 989e12
TILE_RAYS = 65536
TRAIN_RAYS = 2048
ITERS = 20


def flop_per_sample(bands, backward):
    """The paper MLP's operations a sample at the function's widths: the
    forward (K2), or forward + dX + dW (K1); the encoded input's 3 +
    6·bands columns enter layer 0 and the skip layer."""
    d = 3 + 6 * bands
    fwd = [(d, 256), (256, 256), (256, 256), (d + 256, 256), (256, 256), (256, 256), (256, 256),
           (256, 1), (256, 128), (128, 128), (128, 128), (128, 3)]
    dx = [(256, 256)] * 6 + [(256, 1), (256, 128), (128, 128), (128, 128), (128, 3)]
    return sum(2 * k * n for k, n in (fwd + dx + fwd if backward else fwd))


def _bands_args(bands):
    """The band count as the trailing argument of the packing helpers that
    take one, left out at 10 (their default, and all a 10-band tree has)."""
    return () if bands == 10 else (bands,)


def k2_bare(dev, bands, S, with_weights, seed):
    """K2's launch alone on a TILE_RAYS tile: the weights packed and the
    conditioning folded beforehand, the outputs allocated."""
    params = paper_params(seed, dev, False, *_bands_args(bands))
    ro, rd, z, dc, cond, bg = render_inputs(TILE_RAYS, S, torch.Generator().manual_seed(seed), dev)
    packed = K.pack_paper_weights(params, bands)
    fbuf = K._fold_conditioning(packed, cond)
    out = K.render_outputs(TILE_RAYS, S, with_weights, dev)
    return lambda: K._launch_render(packed, fbuf, (ro, rd, z, dc, bg), out, False, False)


def k1_bare(dev, bands, S, seed):
    """K1's launch alone at TRAIN_RAYS rays: the operands packed and the
    outputs and workspace allocated beforehand."""
    bundle, rays = paper_case(TRAIN_RAYS, S, seed, dev, False, *_bands_args(bands))
    operands = K._kernel_operands(bundle, TRAIN_RAYS, dev, bands, True, False, transposed=True)
    out = T.train_outputs(TRAIN_RAYS, S, False, dev, *_bands_args(bands))
    ws = T.train_workspace(TRAIN_RAYS, S, dev, *_bands_args(bands))
    per_ray = (rays["ro"], rays["rd"], rays["z"], rays["tgt"], rays["bg"], rays["noise"])
    kw = dict(num_encoding_fn_xyz=bands, white_background=False, small=False, noise_std=0.1,
              loss_scale=2.0 / (3.0 * TRAIN_RAYS), sup_bg_scale=0.0)
    return lambda: T._launch_train(operands, per_ray, out, ws, **kw)


def measure(dev, bands=10, samples=()):
    """{case: {"ms", "bound_ms", "rays", "samples"}} of K2's two tiles and
    K1's two passes, and of K2's tile and K1's pass at each S of
    `samples`."""
    res = {}
    cases = [("k2_tile_64", lambda: k2_bare(dev, bands, 64, True, 11), TILE_RAYS, 64, False),
             ("k2_tile_128", lambda: k2_bare(dev, bands, 128, False, 12), TILE_RAYS, 128, False),
             ("k1_64", lambda: k1_bare(dev, bands, 64, 21), TRAIN_RAYS, 64, True),
             ("k1_128", lambda: k1_bare(dev, bands, 128, 22), TRAIN_RAYS, 128, True)]
    for S in samples:
        cases += [(f"k2_tile_{S}", lambda S=S: k2_bare(dev, bands, S, False, 13 + S), TILE_RAYS, S, False),
                  (f"k1_{S}", lambda S=S: k1_bare(dev, bands, S, 23 + S), TRAIN_RAYS, S, True)]
    for name, make, R, S, backward in cases:
        fn = make()
        ms = median_ms(fn, warmup=3, iters=ITERS)
        bound = R * S * flop_per_sample(bands, backward) / PEAK_BF16_FLOPS * 1e3
        res[name] = {"ms": ms, "bound_ms": bound, "rays": R, "samples": S}
        print(f"[paper_bands] L={bands} {name}: {R} rays x {S}: bare launch {ms:.4f} ms, operations bound "
              f"{bound:.4f} ms ({bound / ms:.1%} of it)", flush=True)
        del fn
        torch.cuda.empty_cache()
    res["k1_pair"] = {"ms": res["k1_64"]["ms"] + res["k1_128"]["ms"],
                      "bound_ms": res["k1_64"]["bound_ms"] + res["k1_128"]["bound_ms"]}
    print(f"[paper_bands] L={bands} k1_pair: {res['k1_pair']['ms']:.4f} ms", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", type=int, default=10, help="xyz encoding bands (1..31)")
    ap.add_argument("--samples", type=int, nargs="*", default=[], help="more sample counts to time")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paper_bands needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import nerface_tpu_torch

    card = card_line()
    print(card, flush=True)
    print(f"[paper_bands] the package at {nerface_tpu_torch.__file__}", flush=True)
    res = {"card": card, "bands": args.bands, "package": nerface_tpu_torch.__file__,
           "cases": measure(torch.device("cuda", 0), args.bands, args.samples)}
    line = json.dumps(res)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
