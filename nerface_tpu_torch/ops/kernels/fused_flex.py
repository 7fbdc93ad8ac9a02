"""Fused MLP of the Flexible model family: forward and backward.

Port of K4, `nerface_tpu/ops/pallas/fused_flex.py::fused_flex_mlp` (TPU
kernels `_fwd_kernel`, pallas_call at fused_flex.py:247, and `_bwd_kernel`,
pallas_call at fused_flex.py:287). One call evaluates the skip-free
Flexible trunk over (R, S) samples — points ro + rd·z and their positional
encoding, `layer1` with NO activation (+ `v0`, the layer's bias with the
per-frame conditioning folded in), (num_layers − 1) relu'd hidden layers,
σ off the trunk, relu(fc_feat), `layers_dir.0` + the per-ray direction
contribution, relu, `fc_rgb` — and returns the raw radiance [rgb, σ]
(R, S, 4); compositing stays with the caller.

* `pack_flex_weights` is plain differentiable torch: the model's params
  -> the kernel's weights, bf16 (in, out) matrices (`layer1` split into
  its xyz rows `w1a` and encoding rows `w1b`) and f32 bias rows, in the
  JAX package's order (`fused_flex.py:344-356`).
* `fused_flex_forward` / `fused_flex_backward` are the wrappers: on CUDA
  tensors they launch the hand-written kernels of `csrc/fused_flex.cu`
  (K4f, a persistent wgmma kernel; K4b, its recompute, a wgmma dX chain,
  a wgmma dW and two ordered reductions) or raise; on CPU tensors they
  run `fused_flex_forward_reference` / `fused_flex_backward_reference`.
  Each C entry has one call site, `_launch_flex_fwd` / `_launch_flex_bwd`,
  which counts the launch in the wrapper's `.launches`; the kernels read
  the weights as chunk images (`sm90_chunk_image`), written from
  `pack_flex_weights`' matrices by one cached gather
  (`_flex_weight_gather`), and the bands copied once per device
  (`fused_mlp._device_bands`): a call copies nothing from the host.
* The plain versions round to bf16 where the TPU kernel does: every left
  matmul operand (the raw points included) and the weights; the saved
  activations, their relu masks, both operands of dW and the cotangent of
  dX; bias sums and d_v0 / d_dir take the f32 cotangents. With
  `mm_dtype=torch.float32` they are the f32 math.
* `FusedFlexMLP` is the `torch.autograd.Function` (the JAX custom VJP):
  its forward is K4f, its backward K4b; the matrix gradients leave it in
  the weights' bf16, as the JAX VJP returns them (`fused_flex.py:297-299`),
  the bias gradients, d_v0 and d_dir in f32. `fused_flex_mlp` is the
  JAX package's entry point.
* `flex_fused_eligible` is the port's copy of the JAX eligibility check
  (`fused_flex.py:364-385`) and of its pipeline's tile rule
  (`nerface_tpu/render/pipeline.py:287-292`: `kernel_pass_ok`, the ray
  count a multiple of 8) plus what the kernels are built for: hidden width
  a multiple of 256 up to MAX_WIDTH = 1024 (`WIDTHS`; JAX also admits
  1280, 1536, ..., which here run the model's plain forward), any number
  of hidden layers, 1..MAX_FREQS xyz
  bands (JAX has no limit; 21 and more run the plain forward), 1..MAX_SAMPLES
  samples a ray (`fused_mlp.MAX_SAMPLES`, the paper kernels' and K5's
  limit too; JAX has none, and past it the plain forward runs). Any S:
  `csrc/fused_flex.cu` takes the paper kernels' `unit_layout`, S = 64 and
  128 as fixed layout classes, every other S at run time, past ITEM_ROWS
  one ray in ⌈S / 64⌉ units (a long item), and a pass past 10 bands, whose
  encoding is two 64-column blocks, the runtime class at any S.
* The width h is read from the weights (v0 is (1, h)); every layout
  function takes it, h = 256 by default. At h = 512 the two consumer
  warpgroups of a CTA share each unit (`csrc/fused_flex.cu`,
  `wide_chain_kernel` / `wide_dx_kernel`), so a CTA takes one item a round
  (`flex_ctas`); at h = 768 and 1024 too, each layer in slices of 256
  columns (`sliced_chain_kernel` / `sliced_dx_kernel`, a build of the
  runtime layout class for each width: `_lib`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

# K4's sample counts are the paper kernels' (`fused_mlp.MAX_SAMPLES`, one
# `MAX_SAMPLES` in csrc/wgmma_chain.cuh): `kernel_pass_ok` (the JAX
# package's tile rule within 1..MAX_SAMPLES) and `check_samples` (the
# wrappers' refusal, on either device) are the paper kernels' own.
from nerface_tpu_torch.ops.kernels.fused_mlp import (
    DIR_HIDDEN,
    HIDDEN,
    K_XIN,
    K_XIN_WIDE,
    MAX_SAMPLES,
    _check,
    _device_bands,
    _encode_points,
    _ptr,
    check_samples,
    kernel_pass_ok,
    sm90_chunk_image,
    unit_layout,
    xin_extent,
)

# the hidden widths the kernels take, every multiple of HIDDEN up to
# MAX_WIDTH (csrc/fused_flex.cu's, which every C entry point checks);
# layers_dir.0 is h / 2 wide
MAX_WIDTH = 1024
WIDTHS = tuple(range(HIDDEN, MAX_WIDTH + 1, HIDDEN))
# the widths past 512 run csrc/fused_flex.cu's sliced kernels, in a build of
# their own each (`build.flex_sliced_defines`)
SLICED_WIDTHS = tuple(h for h in WIDTHS if h > 2 * HIDDEN)
# K4's xyz encoding bands, 1..MAX_FREQS = 20 (FLEX_MAX_FREQS in
# csrc/fused_flex.cu; the paper kernels take 31): [xyz; PE; 0] is one K_XIN
# block up to 10 bands and two (K = K_XIN_WIDE) from 11, `xin_extent`; W1
# holds that many rows (`w_offsets`' kx), and the f32 rows MAX_FREQS band
# slots
MAX_FREQS = (K_XIN_WIDE - 3) // 6


def check_width(h: int) -> None:
    """K4's wrappers take hidden width 256, 512, 768 or 1024 (`WIDTHS`), on
    either device."""
    if h not in WIDTHS:
        raise ValueError(f"the Flexible kernels take hidden width 256, 512, 768 or 1024 (a multiple of "
                         f"{HIDDEN} up to {MAX_WIDTH}), got {h}")


def weight_names(n_hidden: int) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(matrix names, bias names) in the kernel's order (`_weight_names`)."""
    wn = ("w1a", "w1b") + tuple(f"wh{i}" for i in range(n_hidden)) + ("wf", "wa", "wd0", "wrgb")
    bn = tuple(f"bh{i}" for i in range(n_hidden)) + ("bf", "ba", "bd0", "brgb")
    return wn, bn


def pack_flex_weights(params: Dict[str, torch.Tensor], n_hidden: int, num_encoding_fn_xyz: int):
    """State-dict-named params ({name: tensor}, e.g.
    `dict(model.named_parameters())`) -> the kernel's weights: the bf16
    (in, out) matrices of `weight_names` (w1a (3, h), w1b (6L, h), wh_i,
    wf, wa (h, 1), wd0 (the first h columns of layers_dir.0), wrgb), then
    the f32 (1, out) bias rows. Differentiable."""
    d_pe = 3 + 6 * num_encoding_fn_xyz

    def w(name):
        return params[name + ".weight"]

    def b(name):
        return params[name + ".bias"][None, :]

    h = w("layer1").shape[0]
    mats = [w("layer1")[:, :3].T, w("layer1")[:, 3:d_pe].T]
    mats += [w(f"layers_xyz.{i}").T for i in range(n_hidden)]
    mats += [w("fc_feat").T, w("fc_alpha").T, w("layers_dir.0")[:, :h].T, w("fc_rgb").T]
    biases = [b(f"layers_xyz.{i}") for i in range(n_hidden)]
    biases += [b("fc_feat"), b("fc_alpha"), b("layers_dir.0"), b("fc_rgb")]
    return tuple(m.to(torch.bfloat16) for m in mats) + tuple(biases)


def _unpack(weights: Sequence[torch.Tensor], n_hidden: int):
    wn, bn = weight_names(n_hidden)
    if len(weights) != len(wn) + len(bn):
        raise ValueError(f"{len(weights)} weights, expected {len(wn) + len(bn)} for "
                         f"{n_hidden} hidden layers")
    return dict(zip(wn + bn, weights))


def flex_fused_eligible(model, encode_xyz, pe_dir, n_rays: int, n_samples: int, device) -> bool:
    """Whether `model` can run its radiance field as one `fused_flex_mlp`
    call: a Flexible-family model with view directions, the xyz input and
    its declared encoding, no skip layer engaged (every reference config),
    hidden width in WIDTHS, any number of hidden layers, 1..MAX_FREQS
    bands, 1..MAX_SAMPLES samples a ray, and on the card a pass the JAX package
    sends to its Pallas kernel (`kernel_pass_ok`: its tile picker finds a
    ray tile, so n_rays % 8 == 0)."""
    from nerface_tpu_torch.models.nerf_models import _FlexibleFamily

    if not isinstance(model, _FlexibleFamily):
        return False
    if not model.use_viewdirs or pe_dir is None:
        return False
    if not encode_xyz.include_input or not 1 <= encode_xyz.num_encoding_functions <= MAX_FREQS:
        return False
    if model.dim_xyz != 3 + 6 * encode_xyz.num_encoding_functions:
        return False
    if model.dim_dir < pe_dir.shape[-1]:
        return False
    n_hidden = model.num_layers - 1
    if model.hidden_size not in WIDTHS or n_hidden < 0:
        return False
    if any(model._is_skip_forward(i, n_hidden) for i in range(n_hidden)):
        return False
    if torch.device(device).type == "cuda":
        return kernel_pass_ok(n_rays, n_samples)
    return 1 <= n_samples <= MAX_SAMPLES


# -- plain versions -----------------------------------------------------------


def _rounding(mm_dtype):
    if mm_dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(mm_dtype).float()


def _forward_reference(W, ro, rd, z, dir_c, v0, n_hidden, num_encoding_fn_xyz,
                       log_sampling_xyz, mm_dtype):
    """`fused_flex.py::_forward`: (rgb (R·S, 3), σ (R·S, 1), x3, enc,
    saved activations rounded as the TPU kernel saves them)."""
    r = _rounding(mm_dtype)
    Wr = {k: r(v.float()) for k, v in W.items() if k.startswith("w")}
    n_rays, n_samples = z.shape
    x3 = (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)
    enc = _encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz)

    def dot(a, name):
        return r(a) @ Wr[name]

    a = dot(x3, "w1a") + dot(enc, "w1b") + v0  # layer1: NO relu
    acts = [a]
    for i in range(n_hidden):
        a = torch.relu(dot(a, f"wh{i}") + W[f"bh{i}"])
        acts.append(a)
    feat = torch.relu(dot(a, "wf") + W["bf"])
    alpha = dot(a, "wa") + W["ba"]  # σ off the trunk
    hd = ((dot(feat, "wd0") + W["bd0"]).reshape(n_rays, n_samples, -1)
          + dir_c[:, None, :]).reshape(n_rays * n_samples, -1)
    x0 = torch.relu(hd)
    rgb = dot(x0, "wrgb") + W["brgb"]
    saved = dict(acts=[r(t) for t in acts], feat=r(feat), x0=r(x0))
    return rgb, alpha, x3, enc, saved


def fused_flex_forward_reference(
    weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden: int,
    num_encoding_fn_xyz: int = 10, log_sampling_xyz: bool = True, mm_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of `fused_flex_forward`: (R, S, 4) [rgb, σ]."""
    W = _unpack([t.detach() for t in weights], n_hidden)
    n_rays, n_samples = z_vals.shape
    rgb, alpha, *_ = _forward_reference(
        W, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden,
        num_encoding_fn_xyz, log_sampling_xyz, mm_dtype,
    )
    return torch.cat([rgb, alpha], -1).reshape(n_rays, n_samples, 4)


def fused_flex_backward_reference(
    weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, g, n_hidden: int,
    num_encoding_fn_xyz: int = 10, log_sampling_xyz: bool = True, mm_dtype=torch.bfloat16,
):
    """Plain PyTorch version of `fused_flex_backward`, `_bwd_kernel`
    written out (`fused_flex.py:143-208`): recompute, then the dX chain and
    dW. Returns (d_weights in the weights' order and dtypes, d_v0 (1, h),
    d_dir (R, h/2))."""
    W = _unpack([t.detach() for t in weights], n_hidden)
    n_rays, n_samples = z_vals.shape
    r = _rounding(mm_dtype)
    _, _, x3, enc, s = _forward_reference(
        W, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden,
        num_encoding_fn_xyz, log_sampling_xyz, mm_dtype,
    )
    Wr = {k: r(v.float()) for k, v in W.items() if k.startswith("w")}
    acts, feat, x0 = s["acts"], s["feat"], s["x0"]
    g = g.reshape(-1, 4)
    g_rgb, g_alpha = g[:, :3], g[:, 3:4]

    def dot_t(x, gy):  # dW = xᵀ gy
        return r(x).T @ r(gy)

    def dot_bt(gy, name):  # dx = gy Wᵀ
        return r(gy) @ Wr[name].T

    def m(x):
        return (x > 0).float()

    gw, gb = {}, {}
    gx0 = dot_bt(g_rgb, "wrgb") * m(x0)
    gw["wrgb"] = dot_t(x0, g_rgb)
    gb["brgb"] = g_rgb.sum(0, keepdim=True)
    g_pre_feat = dot_bt(gx0, "wd0")
    gw["wd0"] = dot_t(feat, gx0)
    gb["bd0"] = gx0.sum(0, keepdim=True)
    d_dir = gx0.reshape(n_rays, n_samples, -1).sum(1)
    g_pre_feat = g_pre_feat * m(feat)
    ga = dot_bt(g_pre_feat, "wf") + dot_bt(g_alpha, "wa")
    gw["wf"] = dot_t(acts[n_hidden], g_pre_feat)
    gb["bf"] = g_pre_feat.sum(0, keepdim=True)
    gw["wa"] = dot_t(acts[n_hidden], g_alpha)
    gb["ba"] = g_alpha.sum(0, keepdim=True)
    for i in range(n_hidden - 1, -1, -1):
        g_pre = ga * m(acts[i + 1])
        gw[f"wh{i}"] = dot_t(acts[i], g_pre)
        gb[f"bh{i}"] = g_pre.sum(0, keepdim=True)
        ga = dot_bt(g_pre, f"wh{i}")
    # layer1 has no activation: ga is its pre-activation cotangent
    gw["w1a"] = dot_t(x3, ga)
    gw["w1b"] = dot_t(enc, ga)
    d_v0 = ga.sum(0, keepdim=True)
    wn, bn = weight_names(n_hidden)
    grads = tuple(gw[n].to(W[n].dtype) for n in wn) + tuple(gb[n] for n in bn)
    return grads, d_v0, d_dir


# -- the kernel's operand layout ----------------------------------------------
# Each must equal the offsets computed in csrc/fused_flex.cu (flex_layout);
# tests/test_torch_flex_kernel.py checks it against the source.


def w_offsets(n_hidden: int, h: int = HIDDEN, kx: int = K_XIN) -> Dict[str, int]:
    """bf16 weights, each (in, out) row-major: W1 = [w1a; w1b; 0] (kx, h;
    kx the encoding's extent, `xin_extent`: W1's rows past K_XIN move
    every later offset), WF, WD0, WH0..WH{n-1}, then WA and WRGB (the σ and
    rgb heads, whose gradients are the CTAs' partial sums)."""
    dh = h // 2
    offs = {"W1": 0, "WF": kx * h}
    offs["WD0"] = offs["WF"] + h * h
    wh = offs["WD0"] + h * dh
    for i in range(n_hidden):
        offs[f"WH{i}"] = wh + i * h * h
    offs["WA"] = wh + n_hidden * h * h
    offs["WRGB"] = offs["WA"] + h
    offs["TOTAL"] = offs["WRGB"] + dh * 3
    return offs


def f_offsets(n_hidden: int, h: int = HIDDEN) -> Dict[str, int]:
    """f32 rows: V0 (layer1's folded bias), BF, BD0, BA, BRGB, the encoding's
    frequency bands (MAX_FREQS slots), BH0..BH{n-1}; the same at every band
    count."""
    offs = {"V0": 0, "BF": h, "BD0": 2 * h, "BA": 2 * h + h // 2}
    offs["BRGB"] = offs["BA"] + 1
    offs["FREQS"] = offs["BRGB"] + 3
    for i in range(n_hidden):
        offs[f"BH{i}"] = offs["FREQS"] + MAX_FREQS + i * h
    offs["TOTAL"] = offs["FREQS"] + MAX_FREQS + n_hidden * h
    return offs


def wt_offsets(n_hidden: int, h: int = HIDDEN) -> Dict[str, int]:
    """The dX products' transposed weights, (out, in) row-major: WD0T, WFT,
    WHT0..WHT{n-1}."""
    offs = {"WD0T": 0, "WFT": h // 2 * h}
    for i in range(n_hidden):
        offs[f"WHT{i}"] = offs["WFT"] + (1 + i) * h * h
    offs["TOTAL"] = offs["WFT"] + (1 + n_hidden) * h * h
    return offs


def _pack_rows(W, v0: torch.Tensor, n_hidden: int, freqs: torch.Tensor) -> torch.Tensor:
    """The f32 rows in `f_offsets` order (at the width of v0)."""
    rows = [v0, W["bf"], W["bd0"], W["ba"], W["brgb"],
            torch.cat([freqs, freqs.new_zeros(MAX_FREQS - freqs.numel())])]
    rows += [W[f"bh{i}"] for i in range(n_hidden)]
    return torch.cat([t.reshape(-1).float() for t in rows]).contiguous()


def _forward_matrices(W, n_hidden: int):
    """`w_offsets`' matrices by name, (in, out): W1 = [w1a; w1b; 0], the
    bands' extent kx rows."""
    n_enc = W["w1b"].shape[0]
    pad = W["w1a"].new_zeros(xin_extent(n_enc // 6) - 3 - n_enc, W["w1a"].shape[1])
    mats = {"W1": torch.cat([W["w1a"], W["w1b"], pad]), "WF": W["wf"], "WD0": W["wd0"]}
    mats.update({f"WH{i}": W[f"wh{i}"] for i in range(n_hidden)})
    mats.update(WA=W["wa"], WRGB=W["wrgb"])
    return mats


def _transposed_matrices(W, n_hidden: int):
    """`wt_offsets`' matrices by name, (out, in)."""
    mats = {"WD0T": W["wd0"].T, "WFT": W["wf"].T}
    mats.update({f"WHT{i}": W[f"wh{i}"].T for i in range(n_hidden)})
    return mats


def pack_kernel_operands(W, v0: torch.Tensor, n_hidden: int, freqs: torch.Tensor):
    """(bf16 weights, f32 rows) flat buffers in the `w_offsets` /
    `f_offsets` order, each matrix row-major."""
    h = v0.shape[-1]
    mats = _forward_matrices(W, n_hidden)
    kx = mats["W1"].shape[0]
    wbuf = torch.cat([mats[k].reshape(-1).to(torch.bfloat16) for k in w_offsets(n_hidden, h, kx)
                      if k != "TOTAL"])
    return wbuf.contiguous(), _pack_rows(W, v0, n_hidden, freqs)


def pack_transposed_weights(W, n_hidden: int) -> torch.Tensor:
    """The dX products' bf16 operand buffer in `wt_offsets` order, each
    matrix row-major."""
    mats = _transposed_matrices(W, n_hidden)
    return torch.cat([mats[k].reshape(-1).to(torch.bfloat16) for k in wt_offsets(n_hidden, W["wf"].shape[0])
                      if k != "TOTAL"]).contiguous()


# the matrices the kernels stream as chunk images; WA and WRGB (the heads)
# stay row-major
CHUNKED = ("W1", "WF", "WD0")


def _matrix_shapes(n_hidden: int, n_enc: int, h: int = HIDDEN) -> Dict[str, Tuple[int, int]]:
    """`weight_names`' matrices' shapes, (in, out)."""
    dh = h // 2
    shapes = {"w1a": (3, h), "w1b": (n_enc, h), "wf": (h, h), "wa": (h, 1), "wd0": (h, dh),
              "wrgb": (dh, 3)}
    shapes.update({f"wh{i}": (h, h) for i in range(n_hidden)})
    return shapes


@functools.lru_cache(maxsize=None)
def _flex_weight_gather(n_hidden: int, n_enc: int, device, transposed: bool, h: int = HIDDEN) -> torch.Tensor:
    """Where each element of the kernels' bf16 weight buffer comes from: its
    position in [0; the weights' matrices flat, in `weight_names` order].
    The buffer is the forward weights in `w_offsets` order, each matrix but
    the heads as its chunk images (`sm90_chunk_image`); with `transposed`
    (K4b) the transposed weights' chunk images (`wt_offsets`) come first:
    what imaging `pack_kernel_operands` / `pack_transposed_weights` gives,
    composed into one gather. The transposed part's size, a multiple of
    1024 bytes, keeps the forward weights' start aligned."""
    shapes = _matrix_shapes(n_hidden, n_enc, h)
    idx, o = {}, 1
    for name in weight_names(n_hidden)[0]:
        k, n = shapes[name]
        idx[name] = torch.arange(o, o + k * n, device=device).reshape(k, n)
        o += k * n

    def image(name, m):
        return sm90_chunk_image(m) if name in CHUNKED or name.startswith("WH") else m.reshape(-1)

    parts = [image(k, m) for k, m in _forward_matrices(idx, n_hidden).items()]
    if transposed:
        parts = [sm90_chunk_image(m) for m in _transposed_matrices(idx, n_hidden).values()] + parts
    return torch.cat(parts).contiguous()


def _split_kernel_grads(dwbuf, dfbuf, n_hidden: int, n_enc: int, h: int = HIDDEN):
    """The kernel's packed f32 gradients -> ({matrix name: grad},
    {bias name: (1, out) grad}, d_v0 (1, h)); W1's zero-padded rows are
    dropped (its kx rows at n_enc / 6 bands)."""
    dh = h // 2
    kx = xin_extent(n_enc // 6)
    wo, fo = w_offsets(n_hidden, h, kx), f_offsets(n_hidden, h)

    def mat(name, rows, cols):
        return dwbuf[wo[name]:wo[name] + rows * cols].reshape(rows, cols)

    def row(name, n):
        return dfbuf[fo[name]:fo[name] + n][None, :]

    w1 = mat("W1", kx, h)
    gw = {"w1a": w1[:3], "w1b": w1[3:3 + n_enc], "wf": mat("WF", h, h),
          "wa": mat("WA", h, 1), "wd0": mat("WD0", h, dh),
          "wrgb": mat("WRGB", dh, 3)}
    gb = {"bf": row("BF", h), "ba": row("BA", 1), "bd0": row("BD0", dh),
          "brgb": row("BRGB", 3)}
    for i in range(n_hidden):
        gw[f"wh{i}"] = mat(f"WH{i}", h, h)
        gb[f"bh{i}"] = row(f"BH{i}", h)
    return gw, gb, row("V0", h)


# -- the wrappers -------------------------------------------------------------


def _check_domain(z_vals, v0, n_hidden, num_encoding_fn_xyz):
    """What the wrappers take on either device: 1..MAX_SAMPLES samples a
    ray, hidden width in WIDTHS (v0's), n_hidden ≥ 0, 1..MAX_FREQS xyz
    bands."""
    check_samples(z_vals.shape[-1])
    check_width(v0.shape[-1])
    if n_hidden < 0:
        raise ValueError(f"the Flexible kernels take n_hidden ≥ 0, got {n_hidden}")
    if not 1 <= num_encoding_fn_xyz <= MAX_FREQS:
        raise ValueError(f"the Flexible kernels take 1..{MAX_FREQS} xyz encoding bands, "
                         f"got {num_encoding_fn_xyz}")


def _kernel_call(weights, ro, rd, z, dir_c, v0, n_hidden, num_encoding_fn_xyz, g=None):
    """Check the operands of a kernel launch; returns the weights by name."""
    dev = ro.device
    n_rays, n_samples = z.shape
    _check_domain(z, v0, n_hidden, num_encoding_fn_xyz)
    h = v0.shape[-1]
    _check("ray_origins", ro, (n_rays, 3), dev)
    _check("ray_directions", rd, (n_rays, 3), dev)
    _check("z_vals", z, (n_rays, n_samples), dev)
    _check("dir_contrib", dir_c, (n_rays, h // 2), dev)
    _check("v0", v0, (1, h), dev)
    if g is not None:
        _check("g", g, (n_rays, n_samples, 4), dev)
    W = _unpack([t.detach() for t in weights], n_hidden)
    shapes = _matrix_shapes(n_hidden, 6 * num_encoding_fn_xyz, h)
    for name, t in W.items():
        if name.startswith("w"):
            want = shapes[name]
            if t.dtype != torch.bfloat16 or tuple(t.shape) != want or t.device != dev:
                raise ValueError(f"{name} must be bfloat16 {want} on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        elif t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 1 or t.device != dev:
            raise ValueError(f"{name} must be a float32 (1, n) row on {dev}")
    return W


def _kernel_operands(W, v0, n_hidden, num_encoding_fn_xyz, log_sampling_xyz, transposed):
    """Checked weights by name -> the kernels' operands: (bf16 forward
    weight images, f32 rows), and with `transposed` (K4b) the transposed
    weights' images after them. Both images come out of one gather
    (`_flex_weight_gather`); nothing is copied from the host."""
    dev, h = v0.device, v0.shape[-1]
    n_enc = 6 * num_encoding_fn_xyz
    src = torch.cat([W["w1a"].new_zeros(1)]
                    + [W[n].reshape(-1) for n in weight_names(n_hidden)[0]])
    both = src[_flex_weight_gather(n_hidden, n_enc, dev, transposed, h)]
    fbuf = _pack_rows(W, v0, n_hidden, _device_bands(num_encoding_fn_xyz, log_sampling_xyz, dev))
    if not transposed:
        return both, fbuf
    wt_total = wt_offsets(n_hidden, h)["TOTAL"]
    return both[wt_total:], fbuf, both[:wt_total]


def _lib(n_samples: int, num_encoding_fn_xyz: int, h: int = HIDDEN):
    """The build of `csrc/fused_flex.cu` that holds the layout class of a
    pass of n_samples at num_encoding_fn_xyz bands and width h
    (`build.layout_library`: past 10 bands the runtime class at any S; h =
    256 and 512 in both, 768 and 1024 each in a build of its own at any S,
    `build.flex_sliced_defines`)."""
    from nerface_tpu_torch.ops.kernels.build import flex_sliced_defines, layout_library, load_library

    if h in SLICED_WIDTHS:
        return load_library("fused_flex", flex_sliced_defines(h))
    return layout_library("fused_flex", n_samples, num_encoding_fn_xyz)


def _launch_flex_fwd(operands, per_ray, out, n_hidden, num_encoding_fn_xyz):
    """K4f's C entry on checked CUDA operands: `operands` (W images, f32
    rows) from `_kernel_operands(..., transposed=False)`, `per_ray` (ro,
    rd, z, dir_contrib (R, h / 2)), `out` (R, S, 4) f32. Counts the launch
    in `fused_flex_forward.launches`."""
    wbuf, fbuf = operands
    ro, rd, z, dc = per_ray
    n_rays, n_samples = z.shape
    h = 2 * dc.shape[-1]
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = _lib(n_samples, num_encoding_fn_xyz, h).nerface_fused_flex_fwd(
            _ptr(ro), _ptr(rd), _ptr(z), _ptr(dc), _ptr(wbuf), _ptr(fbuf), _ptr(out), n_rays,
            n_samples, num_encoding_fn_xyz, n_hidden, h, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_flex_forward kernel launch failed: cudaError {err}")
    fused_flex_forward.launches += 1


def flex_bwd_outputs(n_rays: int, n_hidden: int, dev, h: int = HIDDEN,
                     num_encoding_fn_xyz: int = 10) -> Dict[str, torch.Tensor]:
    """K4b's uninitialised f32 outputs: the packed weight and row gradients
    (`w_offsets` at the bands' extent / `f_offsets`) and d_dir (R, h / 2)."""

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    kx = xin_extent(num_encoding_fn_xyz)
    return {"dw": empty(w_offsets(n_hidden, h, kx)["TOTAL"]), "df": empty(f_offsets(n_hidden, h)["TOTAL"]),
            "d_dir": empty(n_rays, h // 2)}


def flex_bwd_workspace(n_rays: int, n_samples: int, n_hidden: int, dev, h: int = HIDDEN,
                       num_encoding_fn_xyz: int = 10) -> torch.Tensor:
    """K4b's device workspace for a pass (`workspace_layout`'s bytes)."""
    nbytes = _lib(n_samples, num_encoding_fn_xyz, h).nerface_fused_flex_workspace_bytes(
        n_rays, n_samples, num_encoding_fn_xyz, n_hidden, h)
    if nbytes < 0:
        raise ValueError(f"K4b takes no pass of {n_rays} × {n_samples} at h = {h}, n = {n_hidden}, "
                         f"{num_encoding_fn_xyz} bands")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_flex_bwd(operands, per_ray, out, ws, n_hidden, num_encoding_fn_xyz):
    """K4b's C entry on checked CUDA operands: `operands` (W images, f32
    rows, WT images) from `_kernel_operands(..., transposed=True)`,
    `per_ray` (ro, rd, z, dir_contrib, g), `out` from `flex_bwd_outputs`,
    `ws` from `flex_bwd_workspace`. Counts the launch in
    `fused_flex_backward.launches`."""
    wbuf, fbuf, wtbuf = operands
    ro, rd, z, dc, g = per_ray
    n_rays, n_samples = z.shape
    h = 2 * dc.shape[-1]
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = _lib(n_samples, num_encoding_fn_xyz, h).nerface_fused_flex_bwd(
            _ptr(ro), _ptr(rd), _ptr(z), _ptr(dc), _ptr(wbuf), _ptr(wtbuf), _ptr(fbuf), _ptr(g),
            _ptr(out["dw"]), _ptr(out["df"]), _ptr(out["d_dir"]), _ptr(ws), n_rays, n_samples,
            num_encoding_fn_xyz, n_hidden, h, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_flex_backward kernel launch failed: cudaError {err}")
    fused_flex_backward.launches += 1


def fused_flex_forward(
    weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden: int,
    num_encoding_fn_xyz: int = 10, log_sampling_xyz: bool = True,
) -> torch.Tensor:
    """K4f: the raw radiance (R, S, 4) f32 of the skip-free Flexible trunk.
    `weights` is `pack_flex_weights(...)`; ro/rd (R, 3), z (R, S),
    dir_contrib (R, h / 2) = pe_dir @ W_dir0[:, h:].T, v0 (1, h), all f32
    and contiguous; h is in WIDTHS, the bands 1..MAX_FREQS."""
    dev = ray_origins.device
    _check_domain(z_vals, v0, n_hidden, num_encoding_fn_xyz)
    if dev.type == "cpu":
        return fused_flex_forward_reference(
            weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden,
            num_encoding_fn_xyz, log_sampling_xyz,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_flex_forward runs on cuda or cpu, not {dev}")
    W = _kernel_call(weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden,
                     num_encoding_fn_xyz)
    operands = _kernel_operands(W, v0, n_hidden, num_encoding_fn_xyz, log_sampling_xyz, False)
    out = torch.empty(*z_vals.shape, 4, dtype=torch.float32, device=dev)
    _launch_flex_fwd(operands, (ray_origins, ray_directions, z_vals, dir_contrib), out, n_hidden,
                     num_encoding_fn_xyz)
    # the operands may be freed on return: the caching allocator hands
    # their memory only to later work on this stream
    return out


fused_flex_forward.launches = 0


def fused_flex_backward(
    weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, g, n_hidden: int,
    num_encoding_fn_xyz: int = 10, log_sampling_xyz: bool = True,
):
    """K4b: the gradients of Σ g·out for the cotangent g (R, S, 4) of
    `fused_flex_forward`'s output. Returns (d_weights in the weights'
    order and dtypes, d_v0 (1, h), d_dir (R, h / 2)), f32 but for the
    matrices' bf16."""
    dev = ray_origins.device
    _check_domain(z_vals, v0, n_hidden, num_encoding_fn_xyz)
    if dev.type == "cpu":
        return fused_flex_backward_reference(
            weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, g, n_hidden,
            num_encoding_fn_xyz, log_sampling_xyz,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_flex_backward runs on cuda or cpu, not {dev}")
    W = _kernel_call(weights, ray_origins, ray_directions, z_vals, dir_contrib, v0, n_hidden,
                     num_encoding_fn_xyz, g=g)
    n_rays, n_samples = z_vals.shape
    h = v0.shape[-1]
    operands = _kernel_operands(W, v0, n_hidden, num_encoding_fn_xyz, log_sampling_xyz, True)
    out = flex_bwd_outputs(n_rays, n_hidden, dev, h, num_encoding_fn_xyz)
    ws = flex_bwd_workspace(n_rays, n_samples, n_hidden, dev, h, num_encoding_fn_xyz)
    _launch_flex_bwd(operands, (ray_origins, ray_directions, z_vals, dir_contrib, g), out, ws,
                     n_hidden, num_encoding_fn_xyz)
    gw, gb, d_v0 = _split_kernel_grads(out["dw"], out["df"], n_hidden, 6 * num_encoding_fn_xyz, h)
    wn, bn = weight_names(n_hidden)
    grads = tuple(gw[n].to(torch.bfloat16) for n in wn) + tuple(gb[n] for n in bn)
    # the operand buffers and the workspace may be freed on return
    return grads, d_v0, out["d_dir"]


fused_flex_backward.launches = 0


# -- the kernels' schedule and workspace, mirrored for the CPU tests ----------
# Each must equal csrc/fused_flex.cu (tests/test_torch_k4_layout.py reads
# the source).

FLEX_CTAS = 132  # the persistent grid's CTAs at most (k1::pass_ctas)
CONSUMERS = 2  # consumer warpgroups of a CTA
WARPS_A_CTA = 4 * CONSUMERS
DWG_WAVE = 132  # dW's CTAs of one wave (wgmma_dw.cuh)
DW_SEG_UNITS = 2048  # units a dW row segment sums at most (fused_flex.cu)


def mask_bytes(h: int = HIDDEN) -> int:
    """A unit's relu mask of an h-wide activation as bits: 4 words a thread
    of a warpgroup's 256 columns (at h = 512 each consumer warpgroup keeps
    its columns' words, `wide_mask`; at h = 768 / 1024 2 words a thread of
    each 128-column block, `slice_mask`)."""
    return 128 * h // 64 * 4


def workspace_buffers(n_hidden: int, h: int = HIDDEN, kx: int = K_XIN) -> Tuple[Tuple[str, int], ...]:
    """K4b's bf16 image buffers and their widths, in the carve's order (xin
    at the encoding's extent kx)."""
    dh = h // 2
    return ((("xin", kx),) + tuple((f"a{i}", h) for i in range(n_hidden + 1))
            + (("feat", h), ("x0", dh), ("gx0", dh), ("gfeat", h))
            + tuple((f"gpre{i}", h) for i in range(n_hidden)) + (("ga0", h),))


def mask_buffers(n_hidden: int) -> Tuple[str, ...]:
    """The relu masks dX applies (`mask_bytes` a unit), after the images:
    feat's, then a_1..a_n's."""
    return ("fmask",) + tuple(f"amask{i}" for i in range(1, n_hidden + 1))


def dw_products(n_hidden: int, h: int = HIDDEN, kx: int = K_XIN) -> Tuple[Tuple[int, int], ...]:
    """dW's products (X width, gY columns), as the kernel launches them
    (`dw_products`): W1 (K = kx), WF, WD0, each WH_i, each by column blocks
    of at most 256 (WD0's 384 at h = 768 as 256 + 128)."""
    mats = [(kx, h), (h, h), (h, h // 2)] + [(h, h)] * n_hidden
    return tuple((k, min(n - c, 256)) for k, n in mats for c in range(0, n, 256))


def dw_segments(n_hidden: int, h: int = HIDDEN, kx: int = K_XIN, units: int = 0) -> int:
    """dW's row segments of a pass of `units` units: one wave over its
    products' CTAs (a pair of X's 64-column blocks each), and at least
    enough that no segment sums more than DW_SEG_UNITS units."""
    tasks = sum((k // 64 + 1) // 2 for k, _ in dw_products(n_hidden, h, kx))
    return max(1 if tasks >= DWG_WAVE else DWG_WAVE // tasks, -(-units // DW_SEG_UNITS))


def flex_ctas(n_rays: int, n_samples: int, h: int = HIDDEN) -> int:
    """The persistent grid's CTAs: one a round, at most FLEX_CTAS; a round
    is two items (one a consumer warpgroup) at h = 256, one item (both
    warpgroups on each unit) at every wider h."""
    rays, _ = unit_layout(n_samples)
    items = -(-n_rays // rays)
    return min(-(-items // CONSUMERS) if h == HIDDEN else items, FLEX_CTAS)


def unit_schedule(n_rays: int, n_samples: int, h: int = HIDDEN):
    """The persistent grid's work, as the kernels walk it: a list of (cta,
    round, warpgroup, unit, live) in each CTA's order. At h = 256 CTA c
    takes rounds c, c + ctas, ...; round r gives warpgroup wg the item 2r +
    wg, whole rays as 64-row units (`unit_layout`: two rays in one unit at
    S = 32, one ray in one at 64 and in two at 128, 8 rays in 3 at S = 24;
    past ITEM_ROWS one ray in ⌈S / 64⌉ units, 5 at S = 320, 16 at 1024);
    item k's units are the pass's units [k·units, (k + 1)·units), its rows
    past its rays' samples pad the last. An item past the last ray is not
    live. At h ≥ 512 CTA c's rounds are the items c, c + ctas, ..., both
    warpgroups on each of their units (an entry for each), every item
    live."""
    wg_rays, units = unit_layout(n_samples)
    items = -(-n_rays // wg_rays)
    rounds = -(-items // CONSUMERS) if h == HIDDEN else items
    out = []
    for cta in range(min(rounds, FLEX_CTAS)):
        for r in range(cta, rounds, FLEX_CTAS):
            if h == HIDDEN:
                out += [(cta, r, wg, (r * CONSUMERS + wg) * units + u, (r * CONSUMERS + wg) * wg_rays < n_rays)
                        for wg in range(CONSUMERS) for u in range(units)]
            else:
                out += [(cta, r, wg, r * units + u, True) for u in range(units) for wg in range(CONSUMERS)]
    return out


def workspace_layout(n_rays: int, n_samples: int, n_hidden: int, h: int = HIDDEN, kx: int = K_XIN):
    """({piece: byte offset}, total bytes) of K4b's workspace, as `carve`
    lays it out at the encoding's extent kx: the image buffers
    (`workspace_buffers`), the relu masks (`mask_buffers`), then the warps'
    and the CTAs' partial rows and dW's segments, each 256-byte aligned."""
    rays, units_an_item = unit_layout(n_samples)
    units = -(-n_rays // rays) * units_an_item
    ctas = flex_ctas(n_rays, n_samples, h)
    part_cols = f_offsets(n_hidden, h)["TOTAL"] + h + 3 * (h // 2)
    pieces = [(name, units * width * 128) for name, width in workspace_buffers(n_hidden, h, kx)]
    pieces += [(name, units * mask_bytes(h)) for name in mask_buffers(n_hidden)]
    pieces += [("warp_part", ctas * WARPS_A_CTA * part_cols * 4), ("tile_part", ctas * part_cols * 4),
               ("dw_part", dw_segments(n_hidden, h, kx, units) * w_offsets(n_hidden, h, kx)["WA"] * 4)]
    offs, o = {}, 0
    for name, nbytes in pieces:
        offs[name] = o
        o = (o + nbytes + 255) // 256 * 256
    return offs, o


class FusedFlexMLP(torch.autograd.Function):
    """`FusedFlexMLP.apply(opts, ro, rd, z, dir_contrib, v0, *weights)` with
    opts = (n_hidden, num_encoding_fn_xyz, log_sampling_xyz): the raw
    radiance (R, S, 4), differentiable in dir_contrib, v0 and the weights."""

    @staticmethod
    def forward(ctx, opts, ro, rd, z, dir_c, v0, *weights):
        n_hidden, n_freqs, log_sampling = opts
        ctx.opts = opts
        ctx.save_for_backward(ro, rd, z, dir_c, v0, *weights)
        return fused_flex_forward(weights, ro, rd, z, dir_c, v0, n_hidden, n_freqs, log_sampling)

    @staticmethod
    def backward(ctx, g):
        n_hidden, n_freqs, log_sampling = ctx.opts
        ro, rd, z, dir_c, v0, *weights = ctx.saved_tensors
        grads, d_v0, d_dir = fused_flex_backward(
            weights, ro, rd, z, dir_c, v0, g.contiguous(), n_hidden, n_freqs, log_sampling
        )
        return (None, None, None, None, d_dir, d_v0) + tuple(grads)


def fused_flex_mlp(
    params: Dict[str, torch.Tensor],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    z_vals: torch.Tensor,
    dir_contrib: torch.Tensor,
    v0: torch.Tensor,
    n_hidden: int,
    num_encoding_fn_xyz: int,
    log_sampling_xyz: bool = True,
) -> torch.Tensor:
    """Fused forward of a skip-free Flexible-family trunk (the JAX
    package's `fused_flex_mlp`): (R, S, 4) radiance, differentiable in the
    params, v0 (1, h) and dir_contrib (R, h/2), and so in whatever
    conditioning the caller folded into them."""
    weights = pack_flex_weights(params, n_hidden, num_encoding_fn_xyz)
    return FusedFlexMLP.apply(
        (n_hidden, num_encoding_fn_xyz, log_sampling_xyz), ray_origins, ray_directions, z_vals,
        dir_contrib, v0, *weights,
    )
