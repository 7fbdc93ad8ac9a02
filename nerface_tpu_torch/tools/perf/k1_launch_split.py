"""K1 (`fused_train_pass`) and K3b (`fused_paper_mlp_backward`) as bare C
launches, and the device time of each kernel they launch, on the card.

The wrappers pack their operands on every call (the bundle → bf16 weight
images and f32 rows), so their CUDA-event time holds that packing. Here the
operands are packed once and only the launch is timed, through the
wrappers' own `_launch_train` / `_launch_paper_bwd` (which count it): a
train step's pair at 2048 rays (coarse S = 64 + fine S = 128, σ-noise and a
background, as `chip_smoke.py`'s `[train_kernel]`), the same for the
smaller model, and K3b at 2048 × 64. Then `torch.profiler` splits each
call's device time by kernel name, each beside two figures of its own
(`launch_bounds`, `launch_row`): its operations at the bf16 dense peak,
the bound its time is read against, and the bytes this design moves at the
memory rate, the workspace's round trip included, a floor of the design
(the TPU kernel moves no workspace).

    python -m nerface_tpu_torch.tools.perf.k1_launch_split [--json PATH]

It prints the card line, one line per case and kernel, and a JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.tools.perf._timing import card_line, median_ms
from nerface_tpu_torch.tools.perf.cases import D_XYZ, paper_case

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
RAYS = 2048
# (K, N) of the paper MLP's products at the function's widths: the forward
# (trunk, fc_feat, σ head, direction branch, rgb head) and dX (every
# product but the two that read the encoded input; the skip layer's h2
# part only); dW has the forward's products
FORWARD_KN = [(D_XYZ, 256), (256, 256), (256, 256), (D_XYZ + 256, 256), (256, 256), (256, 256),
              (256, 256), (256, 1), (256, 128), (128, 128), (128, 128), (128, 3)]
DX_KN = [(256, 256)] * 6 + [(256, 1), (256, 128), (128, 128), (128, 128), (128, 3)]
W5_KN = (256, 256)


def _flop(kn, small):
    f = sum(2 * k * n for k, n in kn)
    return f - (2 * W5_KN[0] * W5_KN[1] if small else 0)


def workspace_row_bytes(small):
    """bf16 bytes a sample row of the workspace holds: (activations, cotangents)."""
    trunk = 5 if small else 6
    acts = 2 * (64 + 256 * trunk + 256 + 3 * 128)  # xin, h*, feat, hd/x0, x1, x2
    cots = 2 * (3 * 128 + 256 + 256 * trunk)  # gx2, gx1, gx0, gfeat, gh*
    return acts, cots


def launch_bounds(R, S, small, k3b=False):
    """Kernel name -> (flop, bytes, what) of one launch of a pass of R rays
    × S samples. `bytes` is what the launch moves in this design: each
    workspace buffer written once and read once by the launch that needs
    it, the ray inputs and outputs and the packed weights with the pass
    kernel, the gradients with the reductions."""
    rows = R * S
    acts, cots = workspace_row_bytes(small)
    fwd, dx, dw = _flop(FORWARD_KN, small), _flop(DX_KN, small), _flop(FORWARD_KN, small)
    w_bytes = 2 * (K.W_OFFSETS["TOTAL"] + K.WT_OFFSETS["TOTAL"]) + 4 * K.F_OFFSETS["TOTAL"]
    if k3b:
        rays = R * 4 * (3 + 3 + S + 128) + rows * 16  # ro rd z dir_c, g
    else:
        rays = R * 4 * (3 + 3 + 3 + 3 + 128 + 2 * S) + R * 4 * (3 + S)  # in; rgb, weights
    grads = 4 * (K.W_OFFSETS["TOTAL"] + K.F_OFFSETS["TOTAL"]) + R * 4 * 128  # dW, dF, d_dir
    dw_in = acts - 2 * 128 + cots  # every buffer but x2
    return {
        "train_pass_kernel": (rows * (fwd + dx), rays + w_bytes + rows * (acts + cots), "fwd+dX"),
        "dw_wgmma_kernel": (rows * dw, rows * dw_in, "dW"),
        "reduce_rows": (0, grads, "sums"),
    }


def launch_row(ms, launches, flop, nbytes, part):
    """One kernel's reading beside its operations bound (the bf16 dense
    peak) and its byte floor (`launch_bounds`' bytes at the memory rate)."""
    ops = flop / PEAK_BF16_FLOPS * 1e3
    return {"ms": ms, "launches": launches, "ops_bound_ms": ops,
            "byte_floor_ms": nbytes / PEAK_BYTES_S * 1e3,
            "of_ops_bound": ops / ms if ms > 0 else 0.0, "flop": flop, "bytes": nbytes,
            "part": part}


def row_text(name, r):
    """A `launch_row` as one line."""
    return (f"{name:18s} {r['ms']:8.3f} ms x{r['launches']:.0f} a call; operations bound "
            f"{r['ops_bound_ms']:.3f} ms ({r['flop'] / 1e9:.1f} GFLOP, {r['of_ops_bound']:.1%} "
            f"of it); byte floor {r['byte_floor_ms']:.3f} ms ({r['bytes'] / 1e6:.1f} MB, "
            f"workspace included; {r['part']})")


def _operands(bundle, R, dev, small, bands=10):
    """The tree's own packing of a bundle for K1 / K3b: (dir_c, W, F, WT)."""
    return K._kernel_operands(bundle, R, dev, bands, True, small, transposed=True)


def k1_bare(bundle, rays, small, bands=10):
    """K1's launch alone (`fused_train._launch_train`), as a function: the
    operands packed and the outputs and workspace allocated beforehand (the
    function's `out` and `ws`, which a call leaves the pass's gradients and
    operand images in)."""
    ro, rd, z = rays["ro"], rays["rd"], rays["z"]
    R, S = z.shape
    operands = _operands(bundle, R, ro.device, small, bands)
    out = T.train_outputs(R, S, False, ro.device, bands)
    ws = T.train_workspace(R, S, ro.device, bands)
    per_ray = (ro, rd, z, rays["tgt"], rays["bg"], rays["noise"])
    kw = dict(num_encoding_fn_xyz=bands, white_background=False, small=small, noise_std=0.1,
              loss_scale=2.0 / (3.0 * R), sup_bg_scale=0.0)

    def launch():
        T._launch_train(operands, per_ray, out, ws, **kw)

    launch.out, launch.ws = out, ws
    return launch


def k3b_bare(bundle, rays, small, bands=10):
    """K3b's launch alone (`fused_mlp._launch_paper_bwd`), operands packed
    beforehand (`out` and `ws` as `k1_bare`'s)."""
    ro, rd, z = rays["ro"], rays["rd"], rays["z"]
    R, S = z.shape
    operands = _operands(bundle, R, ro.device, small, bands)
    out = K.paper_bwd_outputs(R, ro.device, bands)
    ws = K.paper_bwd_workspace(R, S, ro.device, bands)
    per_ray = (ro, rd, z, rays["g"])

    def launch():
        K._launch_paper_bwd(operands, per_ray, out, ws, bands, small)

    launch.out, launch.ws = out, ws
    return launch


def kernel_split(fns, n=5):
    """Device ms a call of each kernel `fns` (a list of launch functions,
    called in turn) launch, by kernel name, under torch.profiler:
    {name: (ms a round, launches a round)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            for f in fns:
                f()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = getattr(e, "device_time_total", None)
            out[e.key] = ((us if us is not None else e.cuda_time_total) / 1e3 / n, e.count / n)
    return out


def short_name(key, names):
    """A kernel's name in a profiler key: the first of `names` in it, else
    the key's start."""
    for frag in names:
        if frag in key:
            return frag
    return key[:60]


def split_rows(fn, bounds):
    """`fn`'s kernels, slowest first, each by its name in `bounds` ({kernel
    name: (flop, bytes, what)} of one call, as `launch_bounds` gives them):
    {name: `launch_row`}."""
    rows = {}
    for key, (ms, count) in sorted(kernel_split([fn]).items(), key=lambda kv: -kv[1][0]):
        name = short_name(key, bounds)
        rows[name] = launch_row(ms, count, *bounds.get(name, (0, 0, "?")))
    return rows


def measure(dev, cases=None):
    """Every case: bare-launch median ms, and each kernel's device ms a
    call beside its operations bound and byte floor. Returns {case: {...}}."""
    cases = cases or [("k1", False, 64), ("k1", False, 128), ("k1", True, 64), ("k1", True, 128),
                      ("k3b", False, 64), ("k3b", True, 64)]
    res = {}
    for c, (which, small, S) in enumerate(cases):
        bundle, rays = paper_case(RAYS, S, 7 + c, dev, small)
        fn = (k1_bare if which == "k1" else k3b_bare)(bundle, rays, small)
        ms = median_ms(fn, warmup=3, iters=15)
        kernels = split_rows(fn, launch_bounds(RAYS, S, small, which == "k3b"))
        label = f"{which}{'_small' if small else ''}_{S}"
        flop_total = sum(v["flop"] for v in kernels.values())
        res[label] = {"bare_ms": ms, "device_ms": sum(v["ms"] for v in kernels.values()),
                      "ops_bound_ms": flop_total / PEAK_BF16_FLOPS * 1e3, "kernels": kernels}
        print(f"[k1_split] {label}: {RAYS} rays x {S}: bare launch {ms:.3f} ms, device "
              f"{res[label]['device_ms']:.3f} ms; operations bound "
              f"{res[label]['ops_bound_ms']:.3f} ms", flush=True)
        for name, v in kernels.items():
            print(f"[k1_split]   {row_text(name, v)}", flush=True)
        del fn
        torch.cuda.empty_cache()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = card_line()
    print(card, flush=True)
    res = measure(torch.device("cuda", 0))
    for tag in ("", "_small"):
        pair = res[f"k1{tag}_64"]["bare_ms"] + res[f"k1{tag}_128"]["bare_ms"]
        print(f"[k1_split] K1{tag} pair (64 + 128) bare launch {pair:.3f} ms", flush=True)
    line = json.dumps({"card": card, "cases": res})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
