"""Probe P1 on Hopper: is the first layer faster as a split K (x3·wa +
enc·wb) or packed (concat(x3, enc)·w, K = 64)?

The port's counterpart of the TPU probe `tools/perf/encoder_concat_probe.py`
(`kernel_split` / `kernel_packed`, pallas_calls at :77 / :82). On Hopper a
wgmma step takes K = 16, so split pads x3's K = 3 to 16 and enc's 60 to 64
(five k16 steps a product) and packed pads 63 to 64 (four). The kernels are
`csrc/probes.cu`'s `encoder_kernel`; `encoder_concat` launches one and
counts its launches, `encoder_reference` is the plain PyTorch version: the
TPU probe's math, bf16 operands and f32 sums, REPS products accumulated.

    python -m nerface_tpu_torch.tools.perf.encoder_concat_probe

prints both variants' ms and TFLOP/s at the TPU probe's sizes (384 × 1024
rows, REPS 8). There the (rows, 256) f32 output dominates (1 KB a row), so
it also times REPS + EXTRA_REPS and reports the matmul's own cost a
repetition from the difference.
"""

from __future__ import annotations

import ctypes
import json

import torch

from nerface_tpu_torch.ops.kernels.fused_mlp import sm90_chunk_image

TILE = 1024
GRID = 384
REPS = 8
EXTRA_REPS = 64
WIDTH = 256
VARIANTS = ("split", "packed")
# the kernel against its plain version: max |kernel − plain| ≤ TOL·max|plain|:
# the same bf16 products summed in f32 in another order
TOL = 1e-3


def _round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def pack_weights(wa: torch.Tensor, wb: torch.Tensor, variant: str) -> torch.Tensor:
    """wa (3, 256) and wb (60, 256) as the kernel reads them: packed, the
    chunk image of [wa; wb; 0]; split, those of [wa; 0] and [wb; 0]."""
    wa, wb = wa.to(torch.bfloat16), wb.to(torch.bfloat16)

    def pad(m):
        return torch.cat([m, m.new_zeros(64 - m.shape[0], WIDTH)])

    if variant == "packed":
        return sm90_chunk_image(pad(torch.cat([wa, wb])))
    if variant == "split":
        return torch.cat([sm90_chunk_image(pad(wa)), sm90_chunk_image(pad(wb))])
    raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def encoder_reference(x3, enc, wa, wb, variant: str, reps: int = REPS) -> torch.Tensor:
    """Plain PyTorch version: acc += bf16(x3)·bf16(wa) + bf16(enc)·bf16(wb)
    (split) or acc += bf16([x3, enc])·bf16([wa; wb]) (packed), `reps` times."""
    if variant == "split":
        one = _round(x3) @ _round(wa) + _round(enc) @ _round(wb)
    elif variant == "packed":
        one = _round(torch.cat([x3, enc], -1)) @ _round(torch.cat([wa, wb]))
    else:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    acc = torch.zeros_like(one)
    for _ in range(reps):
        acc = acc + one
    return acc


def encoder_concat(x3, enc, wa, wb, variant: str, reps: int = REPS,
                   w_img: torch.Tensor | None = None) -> torch.Tensor:
    """`variant`'s (n, 256) f32 sums over x3 (n, 3) and enc (n, 60) f32. On
    CUDA tensors it launches `csrc/probes.cu`'s kernel (n a multiple of 128)
    or raises; on CPU tensors it runs `encoder_reference`. `w_img` is
    `pack_weights(wa, wb, variant)`, packed here when not given."""
    if x3.device.type == "cpu":
        return encoder_reference(x3, enc, wa, wb, variant, reps)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    n = x3.shape[0]
    for name, t, c in (("x3", x3, 3), ("enc", enc, 60)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, c) or not t.is_contiguous() \
                or t.device != x3.device:
            raise ValueError(f"{name} must be a contiguous float32 ({n}, {c}) tensor on {x3.device}")
    if n % 128 or reps < 1:
        raise ValueError("the kernel takes n a multiple of 128 and reps >= 1")
    if w_img is None:
        w_img = pack_weights(wa, wb, variant)
    out = torch.empty(n, WIDTH, dtype=torch.float32, device=x3.device)
    from nerface_tpu_torch.ops.kernels.build import load_library

    lib = load_library("probes")
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = lib.nerface_probe_encoder(
            ctypes.c_void_p(x3.data_ptr()), ctypes.c_void_p(enc.data_ptr()),
            ctypes.c_void_p(w_img.data_ptr()), ctypes.c_void_p(out.data_ptr()), n, reps,
            int(variant == "split"), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"encoder probe kernel launch failed: cudaError {err}")
    encoder_concat.launches += 1
    return out


encoder_concat.launches = 0


def flops(rows: int, reps: int = REPS) -> int:
    """The function's products: reps × (rows, 63) × (63, 256)."""
    return rows * reps * 63 * WIDTH * 2


def nbytes(rows: int) -> int:
    """x3 and enc read and the output written, f32, and the bf16 weights."""
    return rows * (3 + 60 + WIDTH) * 4 + 63 * WIDTH * 2


def run(dev, rows: int = GRID * TILE, seed: int = 0):
    """Both variants on the card at `rows` rows: first one launch of each
    (`launches`: how many that drive made), whose rows are then all held
    against the plain version (max error relative to max|plain|); then the median ms and TFLOP/s at REPS, the ms a
    repetition from the difference of REPS + EXTRA_REPS and REPS, and the
    plain version's ms at REPS."""
    from nerface_tpu_torch.tools.perf._timing import median_ms

    g = torch.Generator().manual_seed(seed)
    x3 = torch.randn(rows, 3, generator=g).to(dev)
    enc = torch.randn(rows, 60, generator=g).to(dev)
    wa = torch.randn(3, WIDTH, generator=g).to(torch.bfloat16).to(dev)
    wb = torch.randn(60, WIDTH, generator=g).to(torch.bfloat16).to(dev)
    imgs = {v: pack_weights(wa, wb, v) for v in VARIANTS}
    n0 = encoder_concat.launches
    outs = {v: encoder_concat(x3, enc, wa, wb, v, w_img=imgs[v]) for v in VARIANTS}
    torch.cuda.synchronize()
    res = {"launches": encoder_concat.launches - n0, "variants": {}}
    for v in VARIANTS:
        got = outs.pop(v)
        ref = encoder_reference(x3, enc, wa, wb, v)
        d = (got - ref).abs()
        r = {"finite": bool(torch.isfinite(got).all()), "max_abs": float(d.max()),
             "max_err": float(d.max() / ref.abs().max())}
        del got, ref, d
        r["ms"] = median_ms(lambda: encoder_concat(x3, enc, wa, wb, v, w_img=imgs[v]), warmup=2,
                            iters=10)
        more = median_ms(lambda: encoder_concat(x3, enc, wa, wb, v, REPS + EXTRA_REPS,
                                                w_img=imgs[v]), warmup=2, iters=10)
        r["tflops"] = flops(rows) / r["ms"] / 1e9
        r["rep_ms"] = (more - r["ms"]) / EXTRA_REPS
        r["rep_tflops"] = flops(rows, 1) / r["rep_ms"] / 1e9 if r["rep_ms"] > 0 else None
        r["plain_ms"] = median_ms(lambda: encoder_reference(x3, enc, wa, wb, v), warmup=1, iters=3)
        res["variants"][v] = r
    return res


def main() -> None:
    dev = torch.device("cuda")
    from nerface_tpu_torch.tools.perf._timing import card_line

    print(card_line())
    res = run(dev)["variants"]
    for v, r in res.items():
        print(f"{v:7s}: {r['ms']:8.3f} ms ({r['tflops']:6.1f} TFLOP/s) at {REPS} reps; "
              f"{r['rep_ms'] * 1e3:8.2f} µs a repetition; max rel err {r['max_err']:.2e} "
              f"(limit {TOL})")
    s, p = res["split"]["rep_ms"], res["packed"]["rep_ms"]
    print(f"faster a repetition: {'packed' if p < s else 'split'} ({min(s, p) / max(s, p):.3f}×)")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
