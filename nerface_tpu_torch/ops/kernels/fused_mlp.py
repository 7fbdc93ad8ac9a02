"""Fused render of the NeRFace paper model: radiance MLP + compositing.

Port of K2, `nerface_tpu/ops/pallas/fused_mlp.py::fused_paper_render`
(TPU kernel `_render_kernel`, pallas_call at fused_mlp.py:811). One call
evaluates the whole radiance field — sample points ro + rd·z, their
positional encoding, the 6×256 trunk with the concat-skip at layer 3, the
σ head, the 128-wide view-direction branch — and composites it per ray,
so neither the (R, S, 63) encoding nor the (R, S, 4) radiance exists in
device memory.

* `fused_paper_render` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel `csrc/fused_paper_render.cu` (bf16 tensor cores,
  f32 accumulation) or raises; on a CPU tensor it runs
  `fused_paper_render_reference`. It counts launches in
  `fused_paper_render.launches`.
* `fused_paper_render_reference` is the plain PyTorch version. With
  `mm_dtype=torch.bfloat16` it rounds matmul operands to bf16 exactly
  where the TPU kernel's `_dot` does (points, encoding and every
  activation entering a matmul; weights), with f32 products and sums;
  with `torch.float32` it is the f32 math of the unfused path.
* `_layout_weights` folds the per-frame conditioning into the `cond0` /
  `cond3` bias rows and lays the matrices out (in, out), as the JAX
  package's function of the same name does; `pack_kernel_operands`
  packs them into the two flat buffers the kernel reads. The offsets
  below are mirrored as `constexpr`s in the .cu file (a CPU test checks
  that they agree).
* `pack_paper_weights` does that packing once per model
  (`PackedPaperWeights`); a call then folds only the conditioning into a
  copy of the f32 rows. The wrapper takes the packed weights or a state
  dict, which it packs on every call.

Disparity keeps the TPU kernel's guard, 1 / max(1e-10, depth / max(acc,
1e-38)): finite where acc = 0 (the unfused path's depth / acc is NaN there).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Union

import torch

from nerface_tpu_torch.ops.encoding import _encoding_columns, _frequency_bands

HIDDEN = 256
DIR_HIDDEN = 128
# Layer 0 and the skip layer read [xyz(3); PE(6N)], padded with zero
# columns to one tensor-core K extent: 64 holds N <= 10 bands.
K_XIN = 64
MAX_FREQS = (K_XIN - 3) // 6
# S values the kernel is compiled for: a tile of 128 sample rows holds
# 128 / S whole rays, and each ray is composited by one warp.
KERNEL_SAMPLES = (32, 64, 128)

# Packed bf16 weights, each (in, out) row-major, in this order.
W_LAYOUT = (
    ("W0", K_XIN, HIDDEN),            # [w0a; w0b; 0]
    ("W1", HIDDEN, HIDDEN),
    ("W2", HIDDEN, HIDDEN),
    ("W3", K_XIN + HIDDEN, HIDDEN),   # [w3xa; w3xb; 0; w3h]
    ("W4", HIDDEN, HIDDEN),
    ("W5", HIDDEN, HIDDEN),
    ("WF", HIDDEN, HIDDEN),
    ("WD0", HIDDEN, DIR_HIDDEN),
    ("WD1", DIR_HIDDEN, DIR_HIDDEN),
    ("WD2", DIR_HIDDEN, DIR_HIDDEN),
    ("WA", HIDDEN, 1),
    ("WRGB", DIR_HIDDEN, 3),
)
# Packed f32 rows: bias rows (cond0/cond3 carry the folded conditioning)
# and the encoding's frequency bands.
F_LAYOUT = (
    ("COND0", HIDDEN), ("B1", HIDDEN), ("B2", HIDDEN), ("COND3", HIDDEN),
    ("B4", HIDDEN), ("B5", HIDDEN), ("BF", HIDDEN),
    ("BD0", DIR_HIDDEN), ("BD1", DIR_HIDDEN), ("BD2", DIR_HIDDEN),
    ("BA", 1), ("BRGB", 3), ("FREQS", 16),
)


def _offsets(layout):
    offs, o = {}, 0
    for name, *dims in layout:
        offs[name] = o
        n = 1
        for d in dims:
            n *= d
        o += n
    offs["TOTAL"] = o
    return offs


W_OFFSETS = _offsets(W_LAYOUT)
F_OFFSETS = _offsets(F_LAYOUT)


def _layout_matrices(params: Dict[str, torch.Tensor], d_pe: int, dc: int):
    """State-dict params -> the kernel-layout f32 matrices, (in, out), and
    bias rows keyed by the JAX package's names; the conditioning columns
    of layers 0 and 3 are left out (`_fold_conditioning`)."""

    def w(name):
        return params[name + ".weight"]

    def b(name):
        return params[name + ".bias"]

    return {
        "w0a": w("layers_xyz.0")[:, :3].T,
        "w0b": w("layers_xyz.0")[:, 3:d_pe].T,
        "w1": w("layers_xyz.1").T,
        "w2": w("layers_xyz.2").T,
        "w3xa": w("layers_xyz.3")[:, :3].T,
        "w3xb": w("layers_xyz.3")[:, 3:d_pe].T,
        "w3h": w("layers_xyz.3")[:, d_pe + dc:].T,
        "w4": w("layers_xyz.4").T,
        "w5": w("layers_xyz.5").T,
        "wf": w("fc_feat").T,
        "wa": w("fc_alpha").T,
        "wd0": w("layers_dir.0")[:, :HIDDEN].T,
        "wd1": w("layers_dir.1").T,
        "wd2": w("layers_dir.2").T,
        "wrgb": w("fc_rgb").T,
        "b1": b("layers_xyz.1"),
        "b2": b("layers_xyz.2"),
        "b4": b("layers_xyz.4"),
        "b5": b("layers_xyz.5"),
        "bf": b("fc_feat"),
        "ba": b("fc_alpha"),
        "bd0": b("layers_dir.0"),
        "bd1": b("layers_dir.1"),
        "bd2": b("layers_dir.2"),
        "brgb": b("fc_rgb"),
    }


def _layout_weights(params: Dict[str, torch.Tensor], cond: torch.Tensor, d_pe: int, dc: int):
    """State-dict params + per-frame cond (expr/3 ⊕ latent) -> (cond0,
    cond3, W) with W the kernel-layout f32 matrices and bias rows keyed by
    the JAX package's names (`fused_mlp.py::_layout_weights`)."""
    w0, w3 = params["layers_xyz.0.weight"], params["layers_xyz.3.weight"]
    cond0 = w0[:, d_pe:d_pe + dc] @ cond + params["layers_xyz.0.bias"]
    cond3 = w3[:, d_pe:d_pe + dc] @ cond + params["layers_xyz.3.bias"]
    return cond0, cond3, _layout_matrices(params, d_pe, dc)


def pack_kernel_operands(cond0, cond3, W, freqs: torch.Tensor):
    """(bf16 weights, f32 rows) flat buffers in `W_LAYOUT` / `F_LAYOUT`
    order, on the params' device."""
    n_enc = W["w0b"].shape[0]
    zpad = W["w0a"].new_zeros(K_XIN - 3 - n_enc, HIDDEN)
    mats = {
        "W0": torch.cat([W["w0a"], W["w0b"], zpad]),
        "W1": W["w1"], "W2": W["w2"],
        "W3": torch.cat([W["w3xa"], W["w3xb"], zpad, W["w3h"]]),
        "W4": W["w4"], "W5": W["w5"], "WF": W["wf"],
        "WD0": W["wd0"], "WD1": W["wd1"], "WD2": W["wd2"],
        "WA": W["wa"], "WRGB": W["wrgb"],
    }
    wbuf = torch.cat(
        [mats[name].reshape(-1) for name, *_ in W_LAYOUT]
    ).to(torch.bfloat16)
    rows = {
        "COND0": cond0, "B1": W["b1"], "B2": W["b2"], "COND3": cond3,
        "B4": W["b4"], "B5": W["b5"], "BF": W["bf"], "BD0": W["bd0"],
        "BD1": W["bd1"], "BD2": W["bd2"], "BA": W["ba"], "BRGB": W["brgb"],
        "FREQS": torch.cat([freqs, freqs.new_zeros(16 - freqs.numel())]),
    }
    fbuf = torch.cat([rows[name].reshape(-1).float() for name, _ in F_LAYOUT])
    return wbuf.contiguous(), fbuf.contiguous()


@dataclasses.dataclass(frozen=True)
class PackedPaperWeights:
    """A paper model's weights packed for the kernel once (`pack_paper_weights`).
    `fbuf`'s COND0/COND3 rows hold the layer-0/3 biases; each call adds
    `cond_w @ cond` to them in a copy. `params` is the state dict, which
    the plain version reads."""

    params: Dict[str, torch.Tensor]
    wbuf: torch.Tensor  # bf16, W_LAYOUT
    fbuf: torch.Tensor  # f32, F_LAYOUT
    cond_w: torch.Tensor  # (2, 256, dc) f32: layers_xyz.0/.3 conditioning columns
    num_encoding_fn_xyz: int
    log_sampling_xyz: bool


def pack_paper_weights(
    params: Dict[str, torch.Tensor], num_encoding_fn_xyz: int = 10, log_sampling_xyz: bool = True
) -> PackedPaperWeights:
    """Check a paper model's state dict and pack it for the kernel."""
    if not 1 <= num_encoding_fn_xyz <= MAX_FREQS:
        raise ValueError(
            f"kernel takes 1..{MAX_FREQS} xyz encoding bands, got {num_encoding_fn_xyz}"
        )
    d_pe = 3 + 6 * num_encoding_fn_xyz
    w0, w3 = params["layers_xyz.0.weight"], params["layers_xyz.3.weight"]
    dc = w0.shape[1] - d_pe
    if w0.shape[0] != HIDDEN or dc < 0 or w3.shape != (HIDDEN, d_pe + dc + HIDDEN):
        raise ValueError(
            f"params do not match num_encoding_fn_xyz={num_encoding_fn_xyz}: layers_xyz.0 "
            f"is {tuple(w0.shape)}, layers_xyz.3 is {tuple(w3.shape)}"
        )
    dev = w0.device
    for k, v in params.items():
        if v.device != dev or v.dtype != torch.float32:
            raise ValueError(f"param {k} must be float32 on {dev}")
    freqs = torch.as_tensor(_frequency_bands(num_encoding_fn_xyz, log_sampling_xyz), device=dev)
    W = _layout_matrices(params, d_pe, dc)
    wbuf, fbuf = pack_kernel_operands(
        params["layers_xyz.0.bias"], params["layers_xyz.3.bias"], W, freqs
    )
    cond_w = torch.stack([w0[:, d_pe:d_pe + dc], w3[:, d_pe:d_pe + dc]]).contiguous()
    return PackedPaperWeights(
        dict(params), wbuf, fbuf, cond_w, num_encoding_fn_xyz, log_sampling_xyz
    )


def _fold_conditioning(packed: PackedPaperWeights, cond: torch.Tensor) -> torch.Tensor:
    """The f32 rows of one call: `packed.fbuf` with cond0 = W0c·cond + b0
    and cond3 = W3c·cond + b3 in its COND0/COND3 rows."""
    fbuf = packed.fbuf.clone()
    folded = packed.cond_w @ cond
    for i, name in enumerate(("COND0", "COND3")):
        o = F_OFFSETS[name]
        fbuf[o:o + HIDDEN] += folded[i]
    return fbuf


def _encode_points(x: torch.Tensor, num_encoding_fn_xyz: int, log_sampling_xyz: bool):
    """sin(x·f + φ) in f32, the kernel's encoding of (N, 3) points."""
    rows, freqs, phase = _encoding_columns(3, num_encoding_fn_xyz, log_sampling_xyz)
    dev = x.device
    t = x[:, torch.as_tensor(rows, device=dev)] * torch.as_tensor(freqs, device=dev)
    return torch.sin(t + torch.as_tensor(phase, device=dev))


def _mlp_reference(W, cond0, cond3, x3, enc, dir_contrib, n_rays, n_samples, mm_dtype):
    """The radiance MLP over (R·S, 3) points and their encoding:
    (raw rgb (R, S, 3), σ (R, S))."""

    def mm(a, w):
        if mm_dtype != torch.float32:
            a = a.to(mm_dtype).float()
            w = w.to(mm_dtype).float()
        return a @ w

    h = torch.relu(mm(x3, W["w0a"]) + mm(enc, W["w0b"]) + cond0)
    h = torch.relu(mm(h, W["w1"]) + W["b1"])
    h = torch.relu(mm(h, W["w2"]) + W["b2"])
    h = torch.relu(mm(x3, W["w3xa"]) + mm(enc, W["w3xb"]) + mm(h, W["w3h"]) + cond3)
    h = torch.relu(mm(h, W["w4"]) + W["b4"])
    h = torch.relu(mm(h, W["w5"]) + W["b5"])
    feat = mm(h, W["wf"]) + W["bf"]
    sigma = (mm(feat, W["wa"]) + W["ba"]).reshape(n_rays, n_samples)
    hd = (mm(feat, W["wd0"]) + W["bd0"]).reshape(n_rays, n_samples, DIR_HIDDEN)
    x = torch.relu(hd + dir_contrib[:, None, :]).reshape(-1, DIR_HIDDEN)
    x = torch.relu(mm(x, W["wd1"]) + W["bd1"])
    x = torch.relu(mm(x, W["wd2"]) + W["bd2"])
    rgb = (mm(x, W["wrgb"]) + W["brgb"]).reshape(n_rays, n_samples, 3)
    return rgb, sigma


def _composite_reference(rgb, sigma, z, rd, background, white_background, out_weights):
    """The TPU kernel's compositing of raw rgb (R, S, 3) and σ (R, S)."""
    # dists: z-deltas, 1e10 on the last sample, scaled by |rd|
    d = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    d = d * torch.sqrt(torch.sum(rd * rd, dim=-1, keepdim=True))
    rgb_act = torch.sigmoid(rgb)
    if background is not None:
        # the last sample's rgb is the raw background pixel, no sigmoid
        rgb_act = torch.cat([rgb_act[:, :-1], background[:, None, :]], dim=1)
    sigma_a = torch.relu(sigma)
    sigma_a = torch.cat([sigma_a[:, :-1], sigma_a[:, -1:] + 1e-6], dim=-1)
    # one_minus_alpha as exp(-σd) directly: 1 - alpha + 1e-10 rounds to
    # exactly 0 for alpha == 1, and log would give -inf
    one_minus_alpha = torch.exp(-sigma_a * d)
    alpha = 1.0 - one_minus_alpha
    log_t = torch.log(one_minus_alpha + 1e-10)
    trans = torch.exp(
        torch.cat([torch.zeros_like(log_t[:, :1]), torch.cumsum(log_t[:, :-1], dim=-1)], dim=-1)
    )
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb_act, dim=1)
    depth = torch.sum(weights * z, dim=1)
    acc = torch.sum(weights, dim=1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-38), min=1e-10)
    if white_background:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    out = {
        "rgb": rgb_map, "disp": disp, "acc": acc, "depth": depth,
        "bg_weight": weights[:, -1],
    }
    if out_weights:
        out["weights"] = weights
    return out


def fused_paper_render_reference(
    params: Dict[str, torch.Tensor],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    z_vals: torch.Tensor,
    dir_contrib: torch.Tensor,
    cond: torch.Tensor,
    background: Optional[torch.Tensor] = None,
    white_background: bool = False,
    num_encoding_fn_xyz: int = 10,
    log_sampling_xyz: bool = True,
    out_weights: bool = False,
    mm_dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of `fused_paper_render` (same arguments and
    outputs). `mm_dtype` is the matmul operand precision: bf16 (the
    kernel's) or f32."""
    n_rays, n_samples = z_vals.shape
    d_pe = 3 + 6 * num_encoding_fn_xyz
    cond0, cond3, W = _layout_weights(params, cond, d_pe, cond.shape[-1])
    ro, rd, z = ray_origins, ray_directions, z_vals
    x3 = (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)
    enc = _encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz)
    rgb, sigma = _mlp_reference(
        W, cond0, cond3, x3, enc, dir_contrib, n_rays, n_samples, mm_dtype
    )
    return _composite_reference(rgb, sigma, z, rd, background, white_background, out_weights)


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_paper_render(
    params: Union[PackedPaperWeights, Dict[str, torch.Tensor]],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    z_vals: torch.Tensor,
    dir_contrib: torch.Tensor,
    cond: torch.Tensor,
    background: Optional[torch.Tensor] = None,
    white_background: bool = False,
    num_encoding_fn_xyz: int = 10,
    log_sampling_xyz: bool = True,
    out_weights: bool = False,
) -> Dict[str, torch.Tensor]:
    """Forward-only fused render. ro/rd (R, 3), z (R, S), dir_contrib
    (R, 128) — `pe_dir @ W_dir0[:, 256:].T` — and cond (108,) = [expr/3;
    latent], all f32; params the model's `pack_paper_weights` or its state
    dict. Returns rgb (R, 3), disp/acc/depth/bg_weight (R,), and weights
    (R, S) when `out_weights`. Semantics of inject_background +
    volume_render_radiance_field at σ-noise 0, with bf16 matmul operands."""
    dev = ray_origins.device
    if dev.type == "cpu":
        return fused_paper_render_reference(
            params.params if isinstance(params, PackedPaperWeights) else params,
            ray_origins, ray_directions, z_vals, dir_contrib, cond,
            background=background, white_background=white_background,
            num_encoding_fn_xyz=num_encoding_fn_xyz,
            log_sampling_xyz=log_sampling_xyz, out_weights=out_weights,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_paper_render runs on cuda or cpu, not {dev}")
    n_rays, n_samples = z_vals.shape
    if n_samples not in KERNEL_SAMPLES:
        raise ValueError(
            f"kernel is built for {KERNEL_SAMPLES} samples per ray, got {n_samples}"
        )
    _check("ray_origins", ray_origins, (n_rays, 3), dev)
    _check("ray_directions", ray_directions, (n_rays, 3), dev)
    _check("z_vals", z_vals, (n_rays, n_samples), dev)
    _check("dir_contrib", dir_contrib, (n_rays, DIR_HIDDEN), dev)
    if background is not None:
        _check("background", background, (n_rays, 3), dev)
    packed = params
    if not isinstance(packed, PackedPaperWeights):
        packed = pack_paper_weights(params, num_encoding_fn_xyz, log_sampling_xyz)
    if (packed.num_encoding_fn_xyz, packed.log_sampling_xyz) != (
        num_encoding_fn_xyz, log_sampling_xyz
    ):
        raise ValueError(
            f"weights packed for {packed.num_encoding_fn_xyz} bands (log "
            f"{packed.log_sampling_xyz}), called with {num_encoding_fn_xyz} (log "
            f"{log_sampling_xyz})"
        )
    if packed.wbuf.device != dev:
        raise ValueError(f"packed weights are on {packed.wbuf.device}, expected {dev}")
    _check("cond", cond, (packed.cond_w.shape[-1],), dev)
    fbuf = _fold_conditioning(packed, cond)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = {
        "rgb": empty(n_rays, 3), "disp": empty(n_rays), "acc": empty(n_rays),
        "depth": empty(n_rays), "bg_weight": empty(n_rays),
    }
    if out_weights:
        out["weights"] = empty(n_rays, n_samples)

    from nerface_tpu_torch.ops.kernels.build import load_library

    lib = load_library("fused_paper_render")

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerface_fused_paper_render(
            ptr(ray_origins), ptr(ray_directions), ptr(z_vals), ptr(dir_contrib),
            ptr(background), ptr(packed.wbuf), ptr(fbuf),
            ptr(out["rgb"]), ptr(out["disp"]), ptr(out["acc"]), ptr(out["depth"]),
            ptr(out["bg_weight"]), ptr(out.get("weights")),
            n_rays, n_samples, num_encoding_fn_xyz, int(bool(white_background)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_paper_render kernel launch failed: cudaError {err}")
    fused_paper_render.launches += 1
    # fbuf (and a per-call wbuf) may be freed on return: the caching
    # allocator hands their memory only to later work on this stream
    return out


fused_paper_render.launches = 0
