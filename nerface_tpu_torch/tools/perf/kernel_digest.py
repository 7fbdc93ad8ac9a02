"""Digests of the paper family's kernels' outputs on fixed inputs, on the
card: K2 (`fused_paper_render`, both modes, 4096 rays at S = 64 with the
weights and a 65536-ray tile at S = 128), K1 (`fused_train_pass`, 2048
rays at S = 64 and 128, σ-noise and a background), K3f
(`fused_paper_mlp_forward`, 2048 × 64 and 1111 × 128), K3b
(`fused_paper_mlp_backward`, 2048 × 64) and K5 (`fused_resample`, 2048
rays, 64 + 64 samples, both regimes), each output tensor's SHA-256.
Two checkouts that print the same digests computed the same bits: the A/B
check of a change that must leave these kernels as they were. Its inputs
come from `tools/perf/cases.py`.

    python -m nerface_tpu_torch.tools.perf.kernel_digest [--json PATH]

It prints the card line, one line per kernel and case, and a JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch

from nerface_tpu_torch.ops.kernels import fused_mlp as K
from nerface_tpu_torch.ops.kernels import fused_resample as K5
from nerface_tpu_torch.ops.kernels import fused_train as T
from nerface_tpu_torch.tools.perf._timing import card_line
from nerface_tpu_torch.tools.perf.cases import paper_case, paper_params, render_inputs, resample_inputs


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def digests(dev):
    """{case: {output: digest}} of every case."""
    res = {}
    for small in (False, True):
        tag = "_small" if small else ""
        for R, S, with_w in ((4096, 64, True), (65536, 128, False)):
            params = paper_params(11 + S + small, dev, small)
            gen = torch.Generator().manual_seed(12 + S + small)
            ro, rd, z, dc, cond, bg = render_inputs(R, S, gen, dev)
            out = K.fused_paper_render(K.pack_paper_weights(params), ro, rd, z, dc, cond, background=bg,
                                       out_weights=with_w, small=small)
            res[f"K2{tag}_{R}x{S}"] = {k: digest(v) for k, v in sorted(out.items())}
        for S in (64, 128):
            bundle, rays = paper_case(2048, S, 21 + S + small, dev, small)
            kw = dict(loss_scale=2.0 / (3.0 * 2048), background=rays["bg"], noise=rays["noise"],
                      noise_std=0.1, small=small)
            out, grads, _ = T.fused_train_pass(bundle, rays["ro"], rays["rd"], rays["z"], rays["tgt"], **kw)
            d = {k: digest(v) for k, v in sorted(out.items()) if v is not None}
            d["grads"] = digest(torch.cat([t.reshape(-1).float() for t in grads]))
            res[f"K1{tag}_2048x{S}"] = d
        bundle, rays = paper_case(2048, 64, 31 + small, dev, small)
        grads = K.fused_paper_mlp_backward(bundle, rays["ro"], rays["rd"], rays["z"], rays["g"], small=small)
        res[f"K3b{tag}_2048x64"] = {"grads": digest(torch.cat([t.reshape(-1).float() for t in grads]))}
        for R, S in ((2048, 64), (1111, 128)):
            bundle, rays = paper_case(R, S, 41 + S + small, dev, small)
            out = K.fused_paper_mlp_forward(bundle, rays["ro"], rays["rd"], rays["z"], small=small)
            res[f"K3f{tag}_{R}x{S}"] = {"out": digest(out)}
    from nerface_tpu_torch.ops.math import linspace01

    z, w, u = resample_inputs(2048, 64, 64, 51, dev)
    res["K5_2048_64+64"] = {"general": digest(K5.fused_resample(z, w, u)),
                            "sorted_u": digest(K5.fused_resample(z, w, linspace01(64, device=dev), sorted_u=True))}
    torch.cuda.synchronize()
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = card_line()
    print(card, flush=True)
    res = digests(torch.device("cuda", 0))
    for case, d in res.items():
        print(f"[digest] {case}: " + ", ".join(f"{k} {v}" for k, v in d.items()), flush=True)
    line = json.dumps({"card": card, "digests": res})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
