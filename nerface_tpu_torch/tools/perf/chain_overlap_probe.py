"""Probe P2 on Hopper: do independent 256-wide matmul → relu chains overlap
one chain's epilogue with another's matmul?

The port's counterpart of the TPU probe `tools/perf/chain_overlap_probe.py`
(`kernel_single` … `kernel_bias_sums`, pallas_call at :119), asking its
question of the wgmma layer chain that K2 (`csrc/fused_paper_render.cu`) is
built on. The kernels are `csrc/probes.cu`'s `chain_kernel` variants (its
header note says what each one runs); `chain_overlap` launches one and
counts its launches, `chain_reference` is the plain PyTorch version: the
TPU probe's math, bf16 operands and f32 sums.

    python -m nerface_tpu_torch.tools.perf.chain_overlap_probe

prints each variant's ms and TFLOP/s at the TPU probe's sizes (384 × 1024
rows of width 256, DEPTH 12) and its error against the plain version on
every row, and bwd_mix's aᵀ·gy product of the last 64 rows against
`bwd_mix_dw_reference`.
"""

from __future__ import annotations

import ctypes
import json

import torch

from nerface_tpu_torch.ops.kernels.fused_mlp import sm90_chunk_image

TILE = 1024
GRID = 384
DEPTH = 12  # matmul + relu pairs a row block
WIDTH = 256
VARIANTS = ("single", "twochain_1wg", "twochain", "twochain_pingpong", "fourchain", "bwd_mix",
            "bias_sums")
# the kernel against its plain version: max |kernel − plain| ≤ a·max|plain|
# and ‖kernel − plain‖ ≤ b·‖plain‖, (a, b) = tolerance(variant). Both round
# every layer's input to bf16 and sum in f32, in another order; where the
# orders put an activation on the other side of a bf16 rounding boundary,
# the flip (2^-8 of it) travels on through the remaining layers. bwd_mix
# masks by the previous layer's sign, so a flipped sign of a near-zero
# element keeps or drops a whole element of the next one: its max error
# is a whole element, its norm error stays small.
TOL = (2e-2, 5e-3)
TOL_BWD_MIX = (0.2, 1e-2)


def tolerance(variant: str):
    """(max, norm) error limits of `variant` against its plain version."""
    return TOL_BWD_MIX if variant == "bwd_mix" else TOL


def _round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """The (256, 256) weight as the kernels read it: 4 chunk images."""
    return sm90_chunk_image(w.to(torch.bfloat16))


def chain_reference(x: torch.Tensor, w: torch.Tensor, variant: str, depth: int = DEPTH):
    """Plain PyTorch version of every variant: a = relu(bf16(a) @ bf16(w))
    `depth` times; bwd_mix: a = (bf16(a) @ bf16(w)) ⊙ (a > 0), depth / 2
    times (its aᵀ·gy sums are not part of the output, as in the TPU probe).
    The sub-tilings and the bias sums change no output."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    wf = _round(w)
    a = x.float()
    if variant == "bwd_mix":
        for _ in range(depth // 2):
            a = (_round(a) @ wf) * (a > 0).float()
        return a
    for _ in range(depth):
        a = torch.relu(_round(a) @ wf)
    return a


def bwd_mix_dw_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of bwd_mix's first dW product on the last 64
    rows of x: bf16(a)ᵀ·bf16(gy), gy = (bf16(a) @ bf16(w)) ⊙ (a > 0), f32
    sums; (256, 256)."""
    a = x[-64:].float()
    gy = (_round(a) @ _round(w)) * (a > 0).float()
    return _round(a).T @ _round(gy)


def chain_overlap(x: torch.Tensor, w: torch.Tensor, variant: str, depth: int = DEPTH,
                  w_img: torch.Tensor | None = None,
                  dw: torch.Tensor | None = None) -> torch.Tensor:
    """The chain of `variant` over x (n, 256) f32 with w (256, 256). On a
    CUDA tensor it launches `csrc/probes.cu`'s kernel (n a multiple of 256,
    depth even) or raises; on a CPU tensor it runs `chain_reference`.
    `w_img` is `pack_weight(w)`, packed here when not given. With bwd_mix a
    (256, 256) f32 `dw` receives the kernel's first aᵀ·gy product on the
    last 64 rows (`bwd_mix_dw_reference` on a CPU tensor)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if dw is not None and (variant != "bwd_mix" or dw.dtype != torch.float32
                           or tuple(dw.shape) != (WIDTH, WIDTH) or not dw.is_contiguous()
                           or dw.device != x.device):
        raise ValueError(f"dw is a contiguous float32 ({WIDTH}, {WIDTH}) tensor on x's device, "
                         "for bwd_mix only")
    if x.device.type == "cpu":
        if dw is not None:
            dw.copy_(bwd_mix_dw_reference(x, w))
        return chain_reference(x, w, variant, depth)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != WIDTH or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 (n, {WIDTH}) tensor")
    if x.shape[0] % 256 or depth < 2 or depth % 2:
        raise ValueError("the kernel takes n a multiple of 256 and an even depth")
    if w_img is None:
        w_img = pack_weight(w)
    if w_img.dtype != torch.bfloat16 or w_img.numel() != WIDTH * WIDTH or w_img.device != x.device:
        raise ValueError("w_img must be pack_weight(w) on x's device")
    out = torch.empty_like(x)
    from nerface_tpu_torch.ops.kernels.build import load_library

    lib = load_library("probes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nerface_probe_chain(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_img.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(dw.data_ptr() if dw is not None else 0),
            x.shape[0], depth, VARIANTS.index(variant), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"chain probe kernel launch failed: cudaError {err}")
    chain_overlap.launches += 1
    return out


chain_overlap.launches = 0


def flops(rows: int, depth: int = DEPTH) -> int:
    """The TPU probe's count: depth products of (rows, 256) × (256, 256)
    (bwd_mix runs depth / 2 iterations of two products)."""
    return rows * depth * WIDTH * WIDTH * 2


def nbytes(rows: int) -> int:
    """x read and the output written, f32, and the bf16 weight."""
    return 2 * rows * WIDTH * 4 + WIDTH * WIDTH * 2


def run(dev, rows: int = GRID * TILE, seed: int = 0):
    """Every variant on the card at `rows` rows: first one launch of each
    (`launches`: how many that drive made), whose rows are then all held
    against the plain version (max and norm error relative to max|plain|
    and ‖plain‖), bwd_mix's dW product too (`dw_max_err`, `dw_norm_err`);
    then the median ms and TFLOP/s of the kernel and of the plain
    version."""
    from nerface_tpu_torch.tools.perf._timing import median_ms

    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, WIDTH, generator=g) * 0.05).to(dev)
    w = (torch.randn(WIDTH, WIDTH, generator=g) * 0.06).to(torch.bfloat16).to(dev)
    w_img = pack_weight(w)
    dw = torch.empty(WIDTH, WIDTH, device=dev)
    n0 = chain_overlap.launches
    outs = {v: chain_overlap(x, w, v, w_img=w_img, dw=dw if v == "bwd_mix" else None)
            for v in VARIANTS}
    torch.cuda.synchronize()
    res = {"launches": chain_overlap.launches - n0, "variants": {}}
    for v in VARIANTS:
        got = outs.pop(v)
        ref = chain_reference(x, w, v)
        d = (got - ref).abs()
        r = {"finite": bool(torch.isfinite(got).all()), "max_abs": float(d.max()),
             "max_err": float(d.max() / ref.abs().max()),
             "norm_err": float(d.norm() / ref.norm())}
        del got, ref, d
        if v == "bwd_mix":
            ref = bwd_mix_dw_reference(x, w)
            d = (dw - ref).abs()
            r.update(dw_finite=bool(torch.isfinite(dw).all()),
                     dw_max_err=float(d.max() / ref.abs().max()),
                     dw_norm_err=float(d.norm() / ref.norm()))
        r["ms"] = median_ms(lambda: chain_overlap(x, w, v, w_img=w_img), warmup=2, iters=10)
        r["tflops"] = flops(rows) / r["ms"] / 1e9
        r["plain_ms"] = median_ms(lambda: chain_reference(x, w, v), warmup=1, iters=3)
        res["variants"][v] = r
    return res


def main() -> None:
    dev = torch.device("cuda")
    from nerface_tpu_torch.tools.perf._timing import card_line

    print(card_line())
    res = run(dev)
    for v, r in res["variants"].items():
        dw = (f"; dW max / norm rel err {r['dw_max_err']:.2e} / {r['dw_norm_err']:.2e} "
              f"(limits {TOL})" if "dw_max_err" in r else "")
        print(f"{v:18s}: {r['ms']:8.3f} ms ({r['tflops']:6.1f} TFLOP/s), max / norm rel err "
              f"{r['max_err']:.2e} / {r['norm_err']:.2e} (limits {tolerance(v)}){dw}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
