"""K4f (`fused_flex_forward`) and K4b (`fused_flex_backward`) as bare C
launches, and the device time of each kernel K4b launches, on the card.

The wrappers check and pack their operands on every call (the weights'
chunk images, one gather; the f32 rows), so their CUDA-event time holds
that work. Here the operands are packed once and only the launch is timed,
through the wrappers' own `_launch_flex_fwd` / `_launch_flex_bwd` (which
count it): K4f on a 65536-ray serving tile and on a train step's 2048 rays
at S = 64 and 128, K4b on the 2048 rays, synth512_lcode's He-scaled trunk
(n = 3 hidden layers) at each hidden width asked for (256, the config's,
512, synth512_lcode_w512's, 768 and 1024, synth512_lcode_w768's and
_w1024's; `--hidden`, 256 and 512 by default) and at its 10 xyz bands or
`--bands` (11..20: a K = 128 encoding, the runtime layout class at every
S). At 10 bands it calls only what every checkout of the port with the
wgmma kernels has, so it times two trees against each other: run it with
PYTHONPATH at each checkout's root, in turns (parent, change, change,
parent). Then `torch.profiler` splits
each K4b call's device
time by kernel, each beside two figures of its own (`launch_bounds`,
`k1_launch_split.launch_row`): its operations at the bf16 dense peak, the
bound its time is read against, and the bytes this design moves at the
memory rate, the workspace's round trip included, a floor of the design
(the TPU kernel moves no workspace).

    python -m nerface_tpu_torch.tools.perf.flex_launch_split [--hidden 256 512 768 1024] [--bands L] [--json PATH]

It prints the card line, one line per case and kernel, and a JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from nerface_tpu_torch.ops.kernels import fused_flex as F
from nerface_tpu_torch.ops.kernels.fused_mlp import xin_extent
from nerface_tpu_torch.tools.perf._timing import card_line, median_ms
from nerface_tpu_torch.tools.perf.cases import flex_case
from nerface_tpu_torch.tools.perf.k1_launch_split import PEAK_BF16_FLOPS, row_text, split_rows

RAYS = 2048
TILE_RAYS = 65536
N_HIDDEN = 3  # synth512_lcode: num_layers 4
WIDTHS = (256, 512)  # the default widths; --hidden takes any of F.WIDTHS


def k4b_kernels(h=256):
    """The kernels K4b launches at width h, in order (h = 512 has its own
    recompute and dX kernels, h = 768 and 1024 theirs)."""
    if h == 256:
        return ("flex_chain_kernel", "flex_dx_kernel", "dw_wgmma_kernel", "reduce_rows")
    if h == 512:
        return ("wide_chain_kernel", "wide_dx_kernel", "dw_wgmma_kernel", "reduce_rows")
    return ("sliced_chain_kernel", "sliced_dx_kernel", "dw_wgmma_kernel", "reduce_rows")


K4B_KERNELS = k4b_kernels()


def forward_kn(n, h=256, bands=10):
    """(K, N) of the forward's products at the function's widths: layer1
    (3 + 6·bands encoded columns), the hidden layers, fc_feat, the σ head,
    layers_dir.0's feat columns, fc_rgb. dW has the same products."""
    return [(3 + 6 * bands, h)] + [(h, h)] * n + [(h, h), (h, 1), (h, h // 2), (h // 2, 3)]


def dx_kn(n, h=256):
    """(K, N) of dX's products: fc_rgb, layers_dir.0, fc_feat, the σ head,
    the hidden layers (layer1's input gets no cotangent)."""
    return [(h // 2, 3), (h, h // 2), (h, h), (h, 1)] + [(h, h)] * n


def flop_per_sample(kn):
    return sum(2 * k * n for k, n in kn)


def workspace_row_bytes(n, h=256, bands=10):
    """Bytes a sample row of the workspace holds: (the recompute's bf16
    images: xin (the bands' extent wide), a_0..a_n, feat, x0; their relu
    masks as bits: feat, a_1..a_n; dX's bf16 cotangents: gx0, gfeat, the
    hidden layers', ga0)."""
    mask = F.mask_bytes(h) // 64
    dh = h // 2
    kx = xin_extent(bands)
    return 2 * (kx + h * (n + 1) + h + dh), mask * (1 + n), 2 * (dh + h + h * n + h)


def launch_bounds(R, S, n, h=256, bands=10):
    """Kernel name -> (flop, bytes, what) of one K4b launch of R rays × S
    samples. `bytes` is what the launch moves in this design: the ray
    inputs, the weights, the activations' images and their relu masks with
    the recompute; g, the transposed weights, the heads' images (x0, a_n),
    the masks, its cotangents' images and d_dir with dX; every image but
    x0 with dW; the gradients with the reductions."""
    rows = R * S
    dh = h // 2
    acts, masks, cots = workspace_row_bytes(n, h, bands)
    wo = F.w_offsets(n, h, xin_extent(bands))["TOTAL"]
    fo, to = F.f_offsets(n, h)["TOTAL"], F.wt_offsets(n, h)["TOTAL"]
    rays = R * 4 * (3 + 3 + S + dh)
    heads = 2 * (dh + h)
    chain, dx, dw, sums = k4b_kernels(h)
    return {
        chain: (rows * flop_per_sample(forward_kn(n, h, bands)),
                rays + 2 * wo + 4 * fo + rows * (acts + masks), "recompute"),
        dx: (rows * flop_per_sample(dx_kn(n, h)),
             rows * (16 + heads + masks + cots) + 2 * to + R * 4 * dh, "dX"),
        dw: (rows * flop_per_sample(forward_kn(n, h, bands)), rows * (acts - 2 * dh + cots), "dW"),
        sums: (0, 4 * (wo + fo), "sums"),
    }


def _args(case):
    return (case["weights"], case["ro"], case["rd"], case["z"], case["dc"], case["v0"])


def wrapper_fns(case):
    """The wrappers' calls, as functions: (K4f, K4b)."""
    a, n, L = _args(case), case["n"], case["bands"]
    return (lambda: F.fused_flex_forward(*a, n, L)), (lambda: F.fused_flex_backward(*a, case["g"], n, L))


def bare_fwd(case):
    """K4f's launch alone (`_launch_flex_fwd`, the one C call), as a
    function: the operands packed and the output allocated beforehand."""
    a, n, L = _args(case), case["n"], case["bands"]
    W = F._kernel_call(*a, n, L)
    operands = F._kernel_operands(W, case["v0"], n, L, True, False)
    out = torch.empty(*case["z"].shape, 4, dtype=torch.float32, device=case["ro"].device)
    per_ray = (case["ro"], case["rd"], case["z"], case["dc"])
    return lambda: F._launch_flex_fwd(operands, per_ray, out, n, L)


def bare_bwd(case):
    """K4b's launch alone (`_launch_flex_bwd`, the one C call), as a
    function: the operands packed, the outputs and the workspace allocated
    beforehand (the function's `out` and `ws`: the packed gradients and the
    workspace's images after a call)."""
    a, n, L = _args(case), case["n"], case["bands"]
    W = F._kernel_call(*a, n, L, g=case["g"])
    R, S = case["z"].shape
    dev = case["ro"].device
    h = case["v0"].shape[-1]
    operands = F._kernel_operands(W, case["v0"], n, L, True, True)
    out = F.flex_bwd_outputs(R, n, dev, h, L)
    ws = F.flex_bwd_workspace(R, S, n, dev, h, L)
    per_ray = (case["ro"], case["rd"], case["z"], case["dc"], case["g"])

    def launch():
        F._launch_flex_bwd(operands, per_ray, out, ws, n, L)

    launch.out, launch.ws = out, ws
    return launch


def measure(dev, h=256, bands=10):
    """K4f at the tile and at 2048 rays, K4b at 2048 rays, S = 64 and 128,
    at hidden width h and `bands` xyz bands: wrapper and bare-launch median
    ms; K4b's kernels' device ms a call, beside their bounds. Returns
    {case: {...}} (cases "RxS", with "@h" past h = 256 and "/L16" past 10
    bands)."""
    res = {}
    for R, S in ((TILE_RAYS, 64), (TILE_RAYS, 128), (RAYS, 64), (RAYS, 128)):
        case = flex_case(R, S, 7 + S, dev, N_HIDDEN, h, bands)
        fwd, bwd = wrapper_fns(case)
        label = f"{R}x{S}" + ("" if h == 256 else f"@{h}") + ("" if bands == 10 else f"/L{bands}")
        iters = 10 if R == TILE_RAYS else 15
        r = {"k4f_ms": median_ms(fwd, warmup=3, iters=iters),
             "k4f_bare_ms": median_ms(bare_fwd(case), warmup=3, iters=iters),
             "k4f_ops_bound_ms": R * S * flop_per_sample(forward_kn(N_HIDDEN, h, bands)) / PEAK_BF16_FLOPS * 1e3}
        print(f"[flex_split] K4f {label}: wrapper {r['k4f_ms']:.3f} ms, bare launch "
              f"{r['k4f_bare_ms']:.3f} ms; operations bound {r['k4f_ops_bound_ms']:.3f} ms", flush=True)
        if R == RAYS:
            bbwd = bare_bwd(case)
            r["k4b_ms"] = median_ms(bwd, warmup=3, iters=10)
            r["k4b_bare_ms"] = median_ms(bbwd, warmup=3, iters=10)
            r["kernels"] = split_rows(bbwd, launch_bounds(R, S, N_HIDDEN, h, bands))
            print(f"[flex_split] K4b {label}: wrapper {r['k4b_ms']:.3f} ms, bare launch "
                  f"{r['k4b_bare_ms']:.3f} ms, device {sum(v['ms'] for v in r['kernels'].values()):.3f} ms",
                  flush=True)
            for name, v in r["kernels"].items():
                print(f"[flex_split]   {row_text(name, v)}", flush=True)
        res[label] = r
        del case, fwd, bwd
        torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, nargs="+", choices=F.WIDTHS, default=list(WIDTHS),
                    help="the hidden widths to measure")
    ap.add_argument("--bands", type=int, default=10, help="xyz encoding bands (1..20)")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    import nerface_tpu_torch

    card = card_line()
    print(card, flush=True)
    print(f"[flex_split] the package at {nerface_tpu_torch.__file__}", flush=True)
    res = {}
    for h in args.hidden:
        res.update(measure(torch.device("cuda", 0), h, args.bands))
        at = ("" if h == 256 else f"@{h}") + ("" if args.bands == 10 else f"/L{args.bands}")
        pair = res[f"{RAYS}x64{at}"]["k4b_bare_ms"] + res[f"{RAYS}x128{at}"]["k4b_bare_ms"]
        print(f"[flex_split] K4b pair (64 + 128) at h = {h}, {args.bands} bands, bare launch {pair:.3f} ms",
              flush=True)
    line = json.dumps({"card": card, "bands": args.bands, "package": nerface_tpu_torch.__file__, "cases": res})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
