"""The NeRFace paper model's MLP as kernels: K2 (MLP + compositing) and K3
(the MLP alone, with its backward).

Port of `nerface_tpu/ops/pallas/fused_mlp.py`: K2 `fused_paper_render`
(TPU kernel `_render_kernel`, pallas_call at fused_mlp.py:811) and K3
`fused_paper_mlp` (TPU kernels `_fwd_kernel`, pallas_call at :473, and
`_bwd_kernel`, pallas_call at :523). Both evaluate the whole radiance
field — sample points ro + rd·z, their positional encoding, the 6×256
trunk (5×256 for the smaller model, `small`) with the concat-skip at
layer 3, the σ head, the 128-wide view-direction branch — so the (R, S,
63) encoding never exists in device memory. K2 also composites each ray
(forward only: eval and serving); K3 returns the raw (R, S, 4) [rgb, σ]
and has a backward (training and σ-noise renders).

* `fused_paper_render` is K2's wrapper: on a CUDA tensor it launches the
  hand-written kernel `csrc/fused_paper_render.cu` (bf16 wgmma, f32
  accumulation) or raises; on a CPU tensor it runs
  `fused_paper_render_reference`. It counts launches in
  `fused_paper_render.launches`.
* `fused_paper_mlp` is K3 as a `torch.autograd.Function` over the kernel
  bundle of `fused_train.py::prefold_paper_params`; its forward is
  `fused_paper_mlp_forward` (K3f, `csrc/fused_paper_mlp.cu`), its
  backward `fused_paper_mlp_backward` (K3b: recompute, dX, dW), each
  counting its launches. Matrix gradients leave the backward rounded to
  bf16, as the JAX package's VJP casts them (`fused_mlp.py:534-537`).
* The plain versions (`*_reference`) round matmul operands to bf16 where
  the TPU kernels' `_dot` does (`mm_dtype=torch.bfloat16`: points,
  encoding and every activation entering a matmul; weights), with f32
  products and sums; with `torch.float32` they are the f32 math.
  `_trunk_forward_reference` / `_trunk_backward_reference` are the JAX
  package's `_trunk_forward` / `_trunk_backward`, shared with K1's plain
  version (`fused_train.py`).
* `_layout_weights` folds the per-frame conditioning into the `cond0` /
  `cond3` bias rows and lays the matrices out (in, out);
  `pack_kernel_operands` packs them into the two flat buffers the kernels
  read, `pack_transposed_weights` the backward's transposed trunk. The
  offsets below are mirrored as `constexpr`s in the .cu/.cuh files (CPU
  tests check that they agree). The encoding [xyz; PE] is zero-padded to
  K = 64 up to 10 bands, to K = 128 from 11 to 20 and to K = 192 from 21 to
  31 (`xin_extent`); W0 and W3 hold that many encoding rows
  (`w_layout(kx)`), and the 10-band layout is `W_LAYOUT`. The smaller model keeps the W5/B5 slots,
  zero: its kernels skip that layer.
* `pack_paper_weights` does K2's packing once per model
  (`PackedPaperWeights`); a call then folds only the conditioning into a
  copy of the f32 rows. K2 reads its weights as `wbuf_sm90`
  (`pack_sm90_chunks`): the same offsets, each matrix's 64-row K chunks
  rewritten as the byte image of wgmma's 128-byte-swizzled K-major B
  operand (`csrc/wgmma_tile.cuh`), so one bulk copy puts a chunk in shared
  memory ready for the tensor cores. K1 and K3b take the same images of
  the weights and of the transposed trunk, gathered from their bundle on
  every call by one cached index (`_backward_weight_gather`); K3f takes
  the weights' images alone, by that index's forward part.

Disparity keeps the TPU kernel's guard, 1 / max(1e-10, depth / max(acc,
1e-38)): finite where acc = 0 (the unfused path's depth / acc is NaN there).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from nerface_tpu_torch.ops.encoding import _frequency_bands, encoding_tables

HIDDEN = 256
DIR_HIDDEN = 128
# Layer 0 and the skip layer read [xyz(3); PE(6N)], padded with zero
# columns to a tensor-core K extent kx (`xin_extent`): K_XIN = 64 holds N <=
# 10 bands, K_XIN_WIDE = 128 (two 64-column blocks) N <= 20, K_XIN_XL = 192
# (three) N <= MAX_FREQS = 31. The paper kernels (K2, K3, K1) take every
# extent; K4 (fused_flex.py, its layer1) the first two, up to its own
# `fused_flex.MAX_FREQS` = 20.
K_XIN = 64
K_XIN_WIDE = 128
K_XIN_XL = 192
MAX_FREQS = (K_XIN_XL - 3) // 6
# F_LAYOUT's band slots: MAX_FREQS and a spare one, which keeps the f32
# rows' total even (`FREQ_SLOTS` in csrc/mma_tile.cuh: K1's partial rows
# are read as float2 pairs past them)
FREQ_SLOTS = 32


def xin_extent(num_encoding_fn_xyz: int) -> int:
    """The encoding's K extent at N bands: K_XIN up to 10, K_XIN_WIDE up
    to 20, else K_XIN_XL (`xin_extent` in csrc/mma_tile.cuh)."""
    n_cols = 3 + 6 * num_encoding_fn_xyz
    return K_XIN if n_cols <= K_XIN else K_XIN_WIDE if n_cols <= K_XIN_WIDE else K_XIN_XL


def check_bands(num_encoding_fn_xyz: int) -> None:
    """The paper kernels' wrappers take 1..MAX_FREQS xyz encoding bands, on
    either device (the CPU runs the kernels' plain versions)."""
    if not 1 <= num_encoding_fn_xyz <= MAX_FREQS:
        raise ValueError(f"the kernels take 1..{MAX_FREQS} xyz encoding bands, got "
                         f"{num_encoding_fn_xyz}")

# The kernels take any sample count S in 1..MAX_SAMPLES, a runtime value:
# one limit (`MAX_SAMPLES` in csrc/wgmma_chain.cuh) for the paper kernels
# (K2, K3f, K1, K3b), the Flexible family's K4f / K4b (`fused_flex`
# imports it) and K5's Sc + Sf (`fused_resample.MAX_TOTAL`).
MAX_SAMPLES = 1024
# An item, the rows a consumer warpgroup takes at once, is whole rays in at
# most four 64-row units (`ITEM_ROWS`) up to S = ITEM_ROWS; past it one
# ray in ⌈S / 64⌉ units (a long item).
ITEM_ROWS = 256


def unit_layout(n_samples: int) -> Tuple[int, int]:
    """(rays, units) of an item at S samples a ray: csrc/wgmma_chain.cuh's
    `UnitLayout::of`. S dividing 64: 64 / S rays in one 64-row unit; S a
    multiple of 64: one ray in S / 64 units; otherwise the ray count up to
    ITEM_ROWS / S whose units hold the most real rows a unit (the fewest
    rays on a tie), one ray in ⌈S / 64⌉ units past ITEM_ROWS / 2; the
    item's rows past rays·S pad its last unit."""
    S = n_samples
    if 64 % S == 0:
        return 64 // S, 1
    if S % 64 == 0:
        return 1, S // 64
    rays, units = 1, -(-S // 64)
    n = 2
    while n * S <= ITEM_ROWS:
        u = -(-(n * S) // 64)
        if n * units > rays * u:
            rays, units = n, u
        n += 1
    return rays, units


def kernel_pass_ok(n_rays: int, n_samples: int) -> bool:
    """Whether a paper-family or Flexible pass of (n_rays, n_samples) goes
    to the hand kernels on the card: the JAX package's rule for its Pallas
    kernels,
    that `_pick_rays_per_tile` (`nerface_tpu/ops/pallas/fused_mlp.py:
    421-432`) finds a ray tile, a multiple of 8 dividing n_rays (so
    n_rays % 8 == 0), within the kernels' 1..MAX_SAMPLES."""
    return 1 <= n_samples <= MAX_SAMPLES and n_rays % 8 == 0


def check_samples(n_samples: int) -> None:
    """The paper kernels' and K4's wrappers take 1..MAX_SAMPLES samples a
    ray, on either device (the CPU runs the kernels' plain versions)."""
    if not 1 <= n_samples <= MAX_SAMPLES:
        raise ValueError(
            f"the kernels take 1..{MAX_SAMPLES} samples per ray, got {n_samples}")

# The kernel bundle's matrices (in, out) and bias rows, in the JAX
# package's order; the smaller model (`small`) has no w5 / b5.
WEIGHT_NAMES = (
    "w0a", "w0b", "w1", "w2", "w3xa", "w3xb", "w3h", "w4", "w5", "wf", "wa",
    "wd0", "wd1", "wd2", "wrgb",
)
BIAS_NAMES = ("b1", "b2", "b4", "b5", "bf", "ba", "bd0", "bd1", "bd2", "brgb")


def bundle_names(small: bool = False):
    """(weight names, bias names) of a kernel bundle."""
    if small:
        return (tuple(n for n in WEIGHT_NAMES if n != "w5"),
                tuple(n for n in BIAS_NAMES if n != "b5"))
    return WEIGHT_NAMES, BIAS_NAMES


def w_layout(kx: int = K_XIN):
    """The packed bf16 weights at encoding extent kx, each (in, out)
    row-major, in this order: W0 and W3 hold kx encoding rows, which move
    every later offset (`w_off` in csrc/mma_tile.cuh)."""
    return (
        ("W0", kx, HIDDEN),            # [w0a; w0b; 0]
        ("W1", HIDDEN, HIDDEN),
        ("W2", HIDDEN, HIDDEN),
        ("W3", kx + HIDDEN, HIDDEN),   # [w3xa; w3xb; 0; w3h]
        ("W4", HIDDEN, HIDDEN),
        ("W5", HIDDEN, HIDDEN),
        ("WF", HIDDEN, HIDDEN),
        ("WD0", HIDDEN, DIR_HIDDEN),
        ("WD1", DIR_HIDDEN, DIR_HIDDEN),
        ("WD2", DIR_HIDDEN, DIR_HIDDEN),
        ("WA", HIDDEN, 1),
        ("WRGB", DIR_HIDDEN, 3),
    )


# The 10-band layout, whose offsets are the .cuh's W_OFF_* constants.
W_LAYOUT = w_layout(K_XIN)
# Packed f32 rows: bias rows (cond0/cond3 carry the folded conditioning)
# and the encoding's frequency bands (FREQ_SLOTS slots, zero past N); the
# same at every extent.
F_LAYOUT = (
    ("COND0", HIDDEN), ("B1", HIDDEN), ("B2", HIDDEN), ("COND3", HIDDEN),
    ("B4", HIDDEN), ("B5", HIDDEN), ("BF", HIDDEN),
    ("BD0", DIR_HIDDEN), ("BD1", DIR_HIDDEN), ("BD2", DIR_HIDDEN),
    ("BA", 1), ("BRGB", 3), ("FREQS", FREQ_SLOTS),
)
# The trunk's transposed weights, (out, in) row-major, for the backward's
# dX products gy @ Wᵀ (K1 and K3b), in this order. They must equal WT_OFF_*
# in csrc/paper_train.cuh (a CPU test checks it). No dX product reads an
# encoding row (the skip layer's dX reads w3h alone), so the layout is the
# same at every extent.
WT_LAYOUT = (
    ("WD2T", DIR_HIDDEN, DIR_HIDDEN),
    ("WD1T", DIR_HIDDEN, DIR_HIDDEN),
    ("WD0T", DIR_HIDDEN, HIDDEN),
    ("WFT", HIDDEN, HIDDEN),
    ("W5T", HIDDEN, HIDDEN),
    ("W4T", HIDDEN, HIDDEN),
    ("W3HT", HIDDEN, HIDDEN),
    ("W2T", HIDDEN, HIDDEN),
    ("W1T", HIDDEN, HIDDEN),
)
WT_SOURCE = {
    "WD2T": "wd2", "WD1T": "wd1", "WD0T": "wd0", "WFT": "wf", "W5T": "w5",
    "W4T": "w4", "W3HT": "w3h", "W2T": "w2", "W1T": "w1",
}


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


@functools.lru_cache(maxsize=None)
def w_offsets(kx: int = K_XIN) -> Dict[str, int]:
    """`w_layout(kx)`'s offsets, in elements, and its TOTAL."""
    return _offsets(w_layout(kx))


W_OFFSETS = w_offsets(K_XIN)
F_OFFSETS = _offsets(F_LAYOUT)
WT_OFFSETS = _offsets(WT_LAYOUT)


def _layout_matrices(params: Dict[str, torch.Tensor], d_pe: int, dc: int, small: bool = False):
    """State-dict params -> the kernel-layout f32 matrices, (in, out), and
    bias rows keyed by the JAX package's names; the conditioning columns
    of layers 0 and 3 are left out (`_fold_conditioning`), and so are
    w5/b5 when `small`."""

    def w(name):
        return params[name + ".weight"]

    def b(name):
        return params[name + ".bias"]

    W = {
        "w0a": w("layers_xyz.0")[:, :3].T,
        "w0b": w("layers_xyz.0")[:, 3:d_pe].T,
        "w1": w("layers_xyz.1").T,
        "w2": w("layers_xyz.2").T,
        "w3xa": w("layers_xyz.3")[:, :3].T,
        "w3xb": w("layers_xyz.3")[:, 3:d_pe].T,
        "w3h": w("layers_xyz.3")[:, d_pe + dc:].T,
        "w4": w("layers_xyz.4").T,
        "wf": w("fc_feat").T,
        "wa": w("fc_alpha").T,
        "wd0": w("layers_dir.0")[:, :HIDDEN].T,
        "wd1": w("layers_dir.1").T,
        "wd2": w("layers_dir.2").T,
        "wrgb": w("fc_rgb").T,
        "b1": b("layers_xyz.1"),
        "b2": b("layers_xyz.2"),
        "b4": b("layers_xyz.4"),
        "bf": b("fc_feat"),
        "ba": b("fc_alpha"),
        "bd0": b("layers_dir.0"),
        "bd1": b("layers_dir.1"),
        "bd2": b("layers_dir.2"),
        "brgb": b("fc_rgb"),
    }
    if not small:
        W["w5"], W["b5"] = w("layers_xyz.5").T, b("layers_xyz.5")
    return W


def _layout_weights(params: Dict[str, torch.Tensor], cond: torch.Tensor, d_pe: int, dc: int,
                    small: bool = False):
    """State-dict params + per-frame cond (expr/3 ⊕ latent) -> (cond0,
    cond3, W) with W the kernel-layout f32 matrices and bias rows keyed by
    the JAX package's names (`fused_mlp.py::_layout_weights`)."""
    w0, w3 = params["layers_xyz.0.weight"], params["layers_xyz.3.weight"]
    cond0 = w0[:, d_pe:d_pe + dc] @ cond + params["layers_xyz.0.bias"]
    cond3 = w3[:, d_pe:d_pe + dc] @ cond + params["layers_xyz.3.bias"]
    return cond0, cond3, _layout_matrices(params, d_pe, dc, small)


def _matrix_shapes(n_enc: int) -> Dict[str, tuple]:
    """(in, out) of every kernel-layout matrix of a bundle with `n_enc`
    encoding columns."""
    shapes = {n: (HIDDEN, HIDDEN) for n in WEIGHT_NAMES}
    shapes.update({"w0a": (3, HIDDEN), "w0b": (n_enc, HIDDEN), "w3xa": (3, HIDDEN),
                   "w3xb": (n_enc, HIDDEN), "wa": (HIDDEN, 1), "wd0": (HIDDEN, DIR_HIDDEN),
                   "wd1": (DIR_HIDDEN, DIR_HIDDEN), "wd2": (DIR_HIDDEN, DIR_HIDDEN),
                   "wrgb": (DIR_HIDDEN, 3)})
    return shapes


def _weight_matrices(W):
    """`w_layout(kx)`'s matrices by name from the kernel-layout matrices
    `W`: W0 and W3 with their encoding rows zero-padded to the bands'
    extent kx (`xin_extent`), and a zero W5 where `W` has no w5 (the
    smaller model)."""
    n_enc = W["w0b"].shape[0]
    zpad = W["w0a"].new_zeros(xin_extent(n_enc // 6) - 3 - n_enc, HIDDEN)
    return {
        "W0": torch.cat([W["w0a"], W["w0b"], zpad]),
        "W1": W["w1"], "W2": W["w2"],
        "W3": torch.cat([W["w3xa"], W["w3xb"], zpad, W["w3h"]]),
        "W4": W["w4"], "W5": W["w5"] if "w5" in W else W["w4"].new_zeros(HIDDEN, HIDDEN),
        "WF": W["wf"], "WD0": W["wd0"], "WD1": W["wd1"], "WD2": W["wd2"],
        "WA": W["wa"], "WRGB": W["wrgb"],
    }


def _transposed_matrices(W):
    """`WT_LAYOUT`'s matrices by name: each (in, out) matrix of `W`
    transposed to (out, in); a zero W5T where `W` has no w5."""
    return {name: W[src].T if src in W else W["w4"].new_zeros(HIDDEN, HIDDEN)
            for name, src in WT_SOURCE.items()}


def _pack_rows(cond0, cond3, W, freqs: torch.Tensor) -> torch.Tensor:
    """The f32 rows in `F_LAYOUT` order; a W without b5 leaves its slot zero."""
    rows = {
        "COND0": cond0, "B1": W["b1"], "B2": W["b2"], "COND3": cond3,
        "B4": W["b4"], "B5": W["b5"] if "b5" in W else W["b4"].new_zeros(HIDDEN),
        "BF": W["bf"], "BD0": W["bd0"], "BD1": W["bd1"], "BD2": W["bd2"],
        "BA": W["ba"], "BRGB": W["brgb"],
        "FREQS": torch.cat([freqs, freqs.new_zeros(FREQ_SLOTS - freqs.numel())]),
    }
    return torch.cat([rows[name].reshape(-1).float() for name, _ in F_LAYOUT]).contiguous()


def pack_kernel_operands(cond0, cond3, W, freqs: torch.Tensor):
    """(bf16 weights, f32 rows) flat buffers in `w_layout(kx)` (kx the
    bands' extent) / `F_LAYOUT` order, on the params' device; a W without
    w5/b5 (the smaller model) leaves their slots zero."""
    mats = _weight_matrices(W)
    wbuf = torch.cat(
        [mats[name].reshape(-1) for name, *_ in W_LAYOUT]
    ).to(torch.bfloat16)
    return wbuf.contiguous(), _pack_rows(cond0, cond3, W, freqs)


def pack_transposed_weights(W) -> torch.Tensor:
    """The dX products' bf16 operand buffer: `WT_LAYOUT`'s matrices, each
    the (in, out) kernel-layout matrix transposed to (out, in); a zero W5T
    for the smaller model."""
    mats = _transposed_matrices(W)
    return torch.cat([mats[name].reshape(-1) for name, *_ in WT_LAYOUT]).to(
        torch.bfloat16).contiguous()


# K rows of one weight chunk: one 128-byte row of 64 bf16 in the image
SM90_KCH = 64
# the matrices K2 streams as chunk images, in W_LAYOUT order; WA and WRGB
# (the heads) stay row-major
SM90_CHUNKED = ("W0", "W1", "W2", "W3", "W4", "W5", "WF", "WD0", "WD1", "WD2")


def sm90_chunk_image(m: torch.Tensor) -> torch.Tensor:
    """A (K, N) matrix, K a multiple of 64, as wgmma's 128-byte-swizzled
    K-major B operand, flat: for each 64-row chunk c, N rows of 64 k (128
    bytes), the 16-byte group g of row n at position g ^ (n % 8). Element
    (k, n) lands at chunk k // 64, byte n·128 + ((k%64 // 8) ^ (n%8))·16 +
    (k%8)·2 of it (`sw128` in csrc/wgmma_tile.cuh)."""
    K, N = m.shape
    if K % SM90_KCH:
        raise ValueError(f"K = {K} is not a multiple of {SM90_KCH}")
    t = m.reshape(K // SM90_KCH, SM90_KCH, N).transpose(1, 2).reshape(K // SM90_KCH, N, 8, 8)
    n = torch.arange(N, device=m.device)[:, None]
    slot = torch.arange(8, device=m.device)[None, :]
    # position p of row n holds group p ^ (n % 8)
    return t[:, n, slot ^ (n % 8), :].reshape(-1).contiguous()


def pack_sm90_chunks(wbuf: torch.Tensor, kx: int = K_XIN) -> torch.Tensor:
    """K2's weight buffer: `wbuf` (`w_layout(kx)`, bf16) with every matrix
    of `SM90_CHUNKED` rewritten by `sm90_chunk_image` in place of its rows;
    the offsets (`w_offsets(kx)`) and the heads are unchanged."""
    parts, offs = [], w_offsets(kx)
    for name, k, n in w_layout(kx):
        m = wbuf[offs[name]:offs[name] + k * n]
        parts.append(sm90_chunk_image(m.reshape(k, n)) if name in SM90_CHUNKED else m)
    return torch.cat(parts).contiguous()


@functools.lru_cache(maxsize=None)
def _backward_weight_gather(small: bool, n_enc: int, device) -> torch.Tensor:
    """Where each element of K1's and K3b's bf16 weight buffer comes from:
    its position in [0; the bundle's matrices flat, in the bundle's
    order]. The buffer is the transposed trunk's chunk images (`WT_LAYOUT`)
    and then the forward weights' (`w_layout(kx)` at the extent of n_enc / 6
    bands, the heads row-major): what
    `pack_sm90_chunks` makes of `pack_transposed_weights` and of
    `pack_kernel_operands`' weights, composed into one gather. The
    transposed trunk comes first: its 917504 bytes keep the forward
    weights' start as aligned as the allocation's."""
    shapes = _matrix_shapes(n_enc)
    idx, o = {}, 1
    for name in bundle_names(small)[0]:
        k, n = shapes[name]
        idx[name] = torch.arange(o, o + k * n, device=device).reshape(k, n)
        o += k * n
    wt, w = _transposed_matrices(idx), _weight_matrices(idx)
    return torch.cat(
        [sm90_chunk_image(wt[name]) for name, *_ in WT_LAYOUT]
        + [sm90_chunk_image(w[name]) if name in SM90_CHUNKED else w[name].reshape(-1)
           for name, *_ in W_LAYOUT]).contiguous()


@functools.lru_cache(maxsize=None)
def _device_bands(num_encoding_fn_xyz: int, log_sampling_xyz: bool, device) -> torch.Tensor:
    """The encoding's frequency bands on `device`, copied there once: a
    copy from the host on every call would wait for the stream."""
    return torch.as_tensor(_frequency_bands(num_encoding_fn_xyz, log_sampling_xyz), device=device)


@dataclasses.dataclass(frozen=True)
class PackedPaperWeights:
    """A paper model's weights packed for K2 once (`pack_paper_weights`).
    `fbuf`'s COND0/COND3 rows hold the layer-0/3 biases; each call adds
    `cond_w @ cond` to them in a copy. `params` is the state dict, which
    the plain version reads."""

    params: Dict[str, torch.Tensor]
    wbuf_sm90: torch.Tensor  # bf16, w_layout(kx)'s offsets, the chunk images
    fbuf: torch.Tensor  # f32, F_LAYOUT
    cond_w: torch.Tensor  # (2, 256, dc) f32: layers_xyz.0/.3 conditioning columns
    num_encoding_fn_xyz: int
    log_sampling_xyz: bool


def pack_paper_weights(
    params: Dict[str, torch.Tensor], num_encoding_fn_xyz: int = 10, log_sampling_xyz: bool = True,
) -> PackedPaperWeights:
    """Check a paper-family model's state dict and pack it for K2 at its
    bands' encoding extent; a trunk with no layers_xyz.5 is the smaller
    model's (`small`)."""
    check_bands(num_encoding_fn_xyz)
    small = "layers_xyz.5.weight" not in params
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
    W = _layout_matrices(params, d_pe, dc, small)
    wbuf, fbuf = pack_kernel_operands(
        params["layers_xyz.0.bias"], params["layers_xyz.3.bias"], W, freqs
    )
    cond_w = torch.stack([w0[:, d_pe:d_pe + dc], w3[:, d_pe:d_pe + dc]]).contiguous()
    return PackedPaperWeights(
        dict(params), pack_sm90_chunks(wbuf, xin_extent(num_encoding_fn_xyz)), fbuf, cond_w,
        num_encoding_fn_xyz, log_sampling_xyz
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
    rows, freqs, phase = encoding_tables(3, num_encoding_fn_xyz, log_sampling_xyz,
                                         torch.float32, x.device)
    return torch.sin(x[:, rows] * freqs + phase)


def _points(ro, rd, z):
    """(R·S, 3) sample points ro + rd·z."""
    return (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)


def _rounder(mm_dtype):
    """A matmul operand as the TPU kernels round it (identity in f32)."""
    if mm_dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(mm_dtype).float()


def _trunk_forward_reference(W, cond0, cond3, dir_c, x3, enc, n_rays, n_samples, mm_dtype):
    """The MLP over (R·S, 3) points and their encoding (the JAX package's
    `_trunk_forward`): W holds the (in, out) matrices and bias rows by
    name, without w5/b5 for the smaller model. Returns (raw rgb (R, S, 3),
    σ (R, S), the activations the backward reads, rounded as the kernels
    keep them)."""
    r = _rounder(mm_dtype)

    def dot(a, name):
        return r(a) @ r(W[name])

    tile = n_rays * n_samples
    h0 = torch.relu(dot(x3, "w0a") + dot(enc, "w0b") + cond0)
    h1 = torch.relu(dot(h0, "w1") + W["b1"])
    h2 = torch.relu(dot(h1, "w2") + W["b2"])
    h3 = torch.relu(dot(x3, "w3xa") + dot(enc, "w3xb") + dot(h2, "w3h") + cond3)
    h4 = torch.relu(dot(h3, "w4") + W["b4"])
    h5 = torch.relu(dot(h4, "w5") + W["b5"]) if "w5" in W else h4
    feat = dot(h5, "wf") + W["bf"]
    sigma = (dot(feat, "wa") + W["ba"]).reshape(n_rays, n_samples)
    hd_pre = ((dot(feat, "wd0") + W["bd0"]).reshape(n_rays, n_samples, DIR_HIDDEN)
              + dir_c[:, None, :]).reshape(tile, DIR_HIDDEN)
    x0 = torch.relu(hd_pre)
    x1 = torch.relu(dot(x0, "wd1") + W["bd1"])
    x2 = torch.relu(dot(x1, "wd2") + W["bd2"])
    rgb = (dot(x2, "wrgb") + W["brgb"]).reshape(n_rays, n_samples, 3)
    acts = {k: r(v) for k, v in dict(h0=h0, h1=h1, h2=h2, h3=h3, h4=h4, h5=h5, feat=feat,
                                     hd_pre=hd_pre, x1=x1, x2=x2).items()}
    return rgb, sigma, acts


def _trunk_backward_reference(W, a, x3, enc, g_rgb, g_alpha, n_rays, n_samples, mm_dtype):
    """The JAX package's `_trunk_backward` (`fused_mlp.py:248-330`): from
    the head cotangents g_rgb (R·S, 3) and g_alpha (R·S, 1) to (weight
    gradients, bias gradients, d_cond0, d_cond3, d_dir (R, 128)). dW takes
    the bf16 activations and a bf16-rounded cotangent, dX rounds the
    cotangent, relu masks are taken on the bf16 activations, bias sums
    take the f32 cotangents."""
    r = _rounder(mm_dtype)

    def dot_t(x, gy):  # dW = xᵀ gy
        return r(x).T @ r(gy)

    def dot_bt(gy, name):  # dx = gy Wᵀ
        return r(gy) @ r(W[name]).T

    def m(x):
        return (x > 0).float()

    gw, gb = {}, {}
    gw["wrgb"] = dot_t(a["x2"], g_rgb)
    gb["brgb"] = g_rgb.sum(0, keepdim=True)
    gx2 = dot_bt(g_rgb, "wrgb") * m(a["x2"])
    gw["wd2"] = dot_t(a["x1"], gx2)
    gb["bd2"] = gx2.sum(0, keepdim=True)
    gx1 = dot_bt(gx2, "wd2") * m(a["x1"])
    gw["wd1"] = dot_t(torch.relu(a["hd_pre"]), gx1)
    gb["bd1"] = gx1.sum(0, keepdim=True)
    gx0 = dot_bt(gx1, "wd1") * m(a["hd_pre"])
    gw["wd0"] = dot_t(a["feat"], gx0)
    gb["bd0"] = gx0.sum(0, keepdim=True)
    d_dir = gx0.reshape(n_rays, n_samples, DIR_HIDDEN).sum(1)
    gw["wa"] = dot_t(a["feat"], g_alpha)
    gb["ba"] = g_alpha.sum(0, keepdim=True)
    gfeat = dot_bt(g_alpha, "wa") + dot_bt(gx0, "wd0")
    gw["wf"] = dot_t(a["h5"], gfeat)
    gb["bf"] = gfeat.sum(0, keepdim=True)
    if "w5" in W:
        gh5 = dot_bt(gfeat, "wf") * m(a["h5"])
        gw["w5"] = dot_t(a["h4"], gh5)
        gb["b5"] = gh5.sum(0, keepdim=True)
        gh4 = dot_bt(gh5, "w5") * m(a["h4"])
    else:  # the smaller model: fc_feat reads h4
        gh4 = dot_bt(gfeat, "wf") * m(a["h4"])
    gw["w4"] = dot_t(a["h3"], gh4)
    gb["b4"] = gh4.sum(0, keepdim=True)
    gh3 = dot_bt(gh4, "w4") * m(a["h3"])
    gw["w3xa"] = dot_t(x3, gh3)
    gw["w3xb"] = dot_t(enc, gh3)
    gw["w3h"] = dot_t(a["h2"], gh3)
    d_cond3 = gh3.sum(0, keepdim=True)
    gh2 = dot_bt(gh3, "w3h") * m(a["h2"])
    gw["w2"] = dot_t(a["h1"], gh2)
    gb["b2"] = gh2.sum(0, keepdim=True)
    gh1 = dot_bt(gh2, "w2") * m(a["h1"])
    gw["w1"] = dot_t(a["h0"], gh1)
    gb["b1"] = gh1.sum(0, keepdim=True)
    gh0 = dot_bt(gh1, "w1") * m(a["h0"])
    gw["w0a"] = dot_t(x3, gh0)
    gw["w0b"] = dot_t(enc, gh0)
    d_cond0 = gh0.sum(0, keepdim=True)
    return gw, gb, d_cond0, d_cond3, d_dir


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
    small: bool = False,
    mm_dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of `fused_paper_render` (same arguments and
    outputs). `mm_dtype` is the matmul operand precision: bf16 (the
    kernel's) or f32."""
    n_rays, n_samples = z_vals.shape
    d_pe = 3 + 6 * num_encoding_fn_xyz
    cond0, cond3, W = _layout_weights(params, cond, d_pe, cond.shape[-1], small)
    x3 = _points(ray_origins, ray_directions, z_vals)
    enc = _encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz)
    rgb, sigma, _ = _trunk_forward_reference(
        W, cond0, cond3, dir_contrib, x3, enc, n_rays, n_samples, mm_dtype
    )
    return _composite_reference(
        rgb, sigma, z_vals, ray_directions, background, white_background, out_weights
    )


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_kernel_call(name, ray_origins, ray_directions, z_vals, num_encoding_fn_xyz):
    """The checks every kernel wrapper makes on a CUDA call; returns the
    device."""
    dev = ray_origins.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    n_rays, n_samples = z_vals.shape
    check_samples(n_samples)
    check_bands(num_encoding_fn_xyz)
    _check("ray_origins", ray_origins, (n_rays, 3), dev)
    _check("ray_directions", ray_directions, (n_rays, 3), dev)
    _check("z_vals", z_vals, (n_rays, n_samples), dev)
    return dev


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


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
    small: bool = False,
) -> Dict[str, torch.Tensor]:
    """Forward-only fused render. ro/rd (R, 3), z (R, S), dir_contrib
    (R, 128) — `pe_dir @ W_dir0[:, 256:].T`, plus the smaller model's
    folded expression columns — and cond (108,) = [expr/3; latent], all
    f32; params the model's `pack_paper_weights` or its state dict. Returns
    rgb (R, 3), disp/acc/depth/bg_weight (R,), and weights (R, S) when
    `out_weights`. Semantics of inject_background +
    volume_render_radiance_field at σ-noise 0, with bf16 matmul operands."""
    dev = ray_origins.device
    state = params.params if isinstance(params, PackedPaperWeights) else params
    if small == ("layers_xyz.5.weight" in state):
        raise ValueError(f"called with small={small} on the weights of the "
                         f"{'paper' if small else 'smaller'} model")
    check_samples(z_vals.shape[-1])
    check_bands(num_encoding_fn_xyz)
    if dev.type == "cpu":
        return fused_paper_render_reference(
            state, ray_origins, ray_directions, z_vals, dir_contrib, cond,
            background=background, white_background=white_background,
            num_encoding_fn_xyz=num_encoding_fn_xyz,
            log_sampling_xyz=log_sampling_xyz, out_weights=out_weights, small=small,
        )
    _check_kernel_call("fused_paper_render", ray_origins, ray_directions, z_vals,
                       num_encoding_fn_xyz)
    n_rays, n_samples = z_vals.shape
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
    if packed.wbuf_sm90.device != dev:
        raise ValueError(f"packed weights are on {packed.wbuf_sm90.device}, expected {dev}")
    _check("cond", cond, (packed.cond_w.shape[-1],), dev)
    fbuf = _fold_conditioning(packed, cond)
    out = render_outputs(n_rays, n_samples, out_weights, dev)
    _launch_render(packed, fbuf, (ray_origins, ray_directions, z_vals, dir_contrib, background),
                   out, white_background, small)
    # fbuf (and a per-call wbuf) may be freed on return: the caching
    # allocator hands their memory only to later work on this stream
    return out


fused_paper_render.launches = 0


def render_outputs(n_rays: int, n_samples: int, out_weights: bool, dev) -> Dict[str, torch.Tensor]:
    """K2's uninitialised f32 outputs for `n_rays` rays."""

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = {
        "rgb": empty(n_rays, 3), "disp": empty(n_rays), "acc": empty(n_rays),
        "depth": empty(n_rays), "bg_weight": empty(n_rays),
    }
    if out_weights:
        out["weights"] = empty(n_rays, n_samples)
    return out


def _launch_render(packed: PackedPaperWeights, fbuf: torch.Tensor, per_ray, out, white_background,
                   small):
    """K2's C entry point on checked CUDA operands: `fbuf` the folded rows
    (`_fold_conditioning`), `per_ray` (ro, rd, z, dir_contrib, background
    or None), `out` from `render_outputs`. Counts the launch in
    `fused_paper_render.launches`."""
    from nerface_tpu_torch.ops.kernels.build import load_library

    ro, rd, z, dc, bg = per_ray
    n_rays, n_samples = z.shape
    lib = load_library("fused_paper_render")
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = lib.nerface_fused_paper_render(
            _ptr(ro), _ptr(rd), _ptr(z), _ptr(dc), _ptr(bg), _ptr(packed.wbuf_sm90), _ptr(fbuf),
            _ptr(out["rgb"]), _ptr(out["disp"]), _ptr(out["acc"]), _ptr(out["depth"]),
            _ptr(out["bg_weight"]), _ptr(out.get("weights")),
            n_rays, n_samples, packed.num_encoding_fn_xyz, int(bool(white_background)),
            int(bool(small)), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_paper_render kernel launch failed: cudaError {err}")
    fused_paper_render.launches += 1


# -- K3: the MLP over a kernel bundle, forward and backward -----------------

def _unbundle(bundle: Sequence[torch.Tensor], small: bool = False):
    """A kernel bundle (cond0, cond3, dir_contrib, *matrices, *bias rows)
    -> (cond0, cond3, dir_contrib, {matrix}, {bias row})."""
    wn, bn = bundle_names(small)
    if len(bundle) != 3 + len(wn) + len(bn):
        raise ValueError(f"bundle has {len(bundle)} tensors, expected {3 + len(wn) + len(bn)}"
                         f" (small={small})")
    W = dict(zip(wn, bundle[3:3 + len(wn)]))
    B = dict(zip(bn, bundle[3 + len(wn):]))
    return bundle[0], bundle[1], bundle[2], W, B


def _regroup(d_cond0, d_cond3, d_dir, gw, gb, small):
    """Gradients by name -> a tuple in the bundle's order."""
    wn, bn = bundle_names(small)
    return (d_cond0, d_cond3, d_dir) + tuple(gw[n] for n in wn) + tuple(gb[n] for n in bn)


def _kernel_operands(bundle, n_rays, dev, num_encoding_fn_xyz, log_sampling_xyz, small,
                     transposed):
    """Check a bundle for a kernel call and pack it: (dir_contrib, bf16
    weights, f32 rows, bf16 transposed trunk or None). The weights come as
    their chunk images, gathered straight from the bundle by one cached
    index (`_backward_weight_gather`): with `transposed` (the backward
    kernels, K1 and K3b) the transposed trunk's too, else (K3f) the
    forward weights' alone, by that index's forward part."""
    bundle = [t.detach() for t in bundle]
    cond0, cond3, dir_c, W, B = _unbundle(bundle, small)
    n_enc = 6 * num_encoding_fn_xyz
    _check("dir_contrib", dir_c, (n_rays, DIR_HIDDEN), dev)
    _check("cond0", cond0, (1, HIDDEN), dev)
    _check("cond3", cond3, (1, HIDDEN), dev)
    shapes = _matrix_shapes(n_enc)
    for name, t in W.items():
        want = shapes[name]
        if t.dtype != torch.float32 or tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"{name} must be float32 {want} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in B.items():
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 1 or t.device != dev:
            raise ValueError(f"{name} must be a float32 (1, n) row on {dev}")
    freqs = _device_bands(num_encoding_fn_xyz, log_sampling_xyz, dev)
    Wk = dict(W)
    Wk.update({k: v.reshape(-1) for k, v in B.items()})
    fbuf = _pack_rows(cond0.reshape(-1), cond3.reshape(-1), Wk, freqs)
    src = torch.cat([dir_c.new_zeros(1)] + [W[n].reshape(-1) for n in bundle_names(small)[0]])
    src = src.to(torch.bfloat16)
    idx, wt_total = _backward_weight_gather(small, n_enc, dev), WT_OFFSETS["TOTAL"]
    if not transposed:  # K3f: the forward weights' part of the one index
        return dir_c, src[idx[wt_total:]], fbuf, None
    both = src[idx]
    return dir_c, both[wt_total:], fbuf, both[:wt_total]


def _split_kernel_grads(dwbuf, dfbuf, n_enc, small=False):
    """The kernels' packed f32 gradients (`w_layout(kx)` at the extent of
    n_enc / 6 bands, `F_LAYOUT`) -> ((d_cond0, d_cond3), weight gradients,
    bias gradients) in the bundle's shapes; the zero-padded rows of W0/W3
    (and the smaller model's W5/B5 slots) are dropped."""
    kx = xin_extent(n_enc // 6)
    offs = w_offsets(kx)

    def mat(name, rows, cols):
        o = offs[name]
        return dwbuf[o:o + rows * cols].reshape(rows, cols)

    w0 = mat("W0", kx, HIDDEN)
    w3 = mat("W3", kx + HIDDEN, HIDDEN)
    gw = {
        "w0a": w0[:3], "w0b": w0[3:3 + n_enc], "w1": mat("W1", HIDDEN, HIDDEN),
        "w2": mat("W2", HIDDEN, HIDDEN), "w3xa": w3[:3], "w3xb": w3[3:3 + n_enc],
        "w3h": w3[kx:], "w4": mat("W4", HIDDEN, HIDDEN), "w5": mat("W5", HIDDEN, HIDDEN),
        "wf": mat("WF", HIDDEN, HIDDEN), "wa": mat("WA", HIDDEN, 1),
        "wd0": mat("WD0", HIDDEN, DIR_HIDDEN), "wd1": mat("WD1", DIR_HIDDEN, DIR_HIDDEN),
        "wd2": mat("WD2", DIR_HIDDEN, DIR_HIDDEN), "wrgb": mat("WRGB", DIR_HIDDEN, 3),
    }
    frow = {"b1": "B1", "b2": "B2", "b4": "B4", "b5": "B5", "bf": "BF", "ba": "BA",
            "bd0": "BD0", "bd1": "BD1", "bd2": "BD2", "brgb": "BRGB"}
    width = {"ba": 1, "brgb": 3, "bd0": DIR_HIDDEN, "bd1": DIR_HIDDEN, "bd2": DIR_HIDDEN}

    def row(name, n):
        o = F_OFFSETS[name]
        return dfbuf[o:o + n][None, :]

    gb = {k: row(v, width.get(k, HIDDEN)) for k, v in frow.items()}
    if small:
        del gw["w5"], gb["b5"]
    return (row("COND0", HIDDEN), row("COND3", HIDDEN)), gw, gb


def _recompute(bundle, ro, rd, z, num_encoding_fn_xyz, log_sampling_xyz, small, mm_dtype):
    cond0, cond3, dir_c, W, B = _unbundle([t.detach() for t in bundle], small)
    W.update(B)
    n_rays, n_samples = z.shape
    x3 = _points(ro, rd, z)
    enc = _encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz)
    rgb, sigma, acts = _trunk_forward_reference(
        W, cond0, cond3, dir_c, x3, enc, n_rays, n_samples, mm_dtype)
    return W, x3, enc, rgb, sigma, acts


def fused_paper_mlp_reference(
    bundle, ray_origins, ray_directions, z_vals, *, num_encoding_fn_xyz=10,
    log_sampling_xyz=True, small=False, mm_dtype=torch.bfloat16,
):
    """Plain PyTorch version of `fused_paper_mlp_forward`: raw [rgb, σ]
    (R, S, 4) of the bundle's MLP at the samples."""
    *_, rgb, sigma, _ = _recompute(bundle, ray_origins, ray_directions, z_vals,
                                   num_encoding_fn_xyz, log_sampling_xyz, small, mm_dtype)
    return torch.cat([rgb, sigma[..., None]], dim=-1)


def fused_paper_mlp_backward_reference(
    bundle, ray_origins, ray_directions, z_vals, g, *, num_encoding_fn_xyz=10,
    log_sampling_xyz=True, small=False, mm_dtype=torch.bfloat16,
):
    """Plain PyTorch version of `fused_paper_mlp_backward`: recompute the
    forward, then the trunk backward from g (R, S, 4), the cotangent of
    [rgb, σ]. Returns f32 gradients in the bundle's order and shapes."""
    n_rays, n_samples = z_vals.shape
    W, x3, enc, _, _, acts = _recompute(bundle, ray_origins, ray_directions, z_vals,
                                        num_encoding_fn_xyz, log_sampling_xyz, small, mm_dtype)
    g = g.reshape(n_rays * n_samples, 4)
    gw, gb, d_cond0, d_cond3, d_dir = _trunk_backward_reference(
        W, acts, x3, enc, g[:, :3], g[:, 3:4], n_rays, n_samples, mm_dtype)
    return _regroup(d_cond0, d_cond3, d_dir, gw, gb, small)


def fused_paper_mlp_forward(
    bundle, ray_origins, ray_directions, z_vals, *, num_encoding_fn_xyz=10,
    log_sampling_xyz=True, small=False,
):
    """K3f: raw [rgb, σ] (R, S, 4) f32 of the bundle's MLP. On CUDA
    tensors it launches `csrc/fused_paper_mlp.cu`'s forward kernel or
    raises; on CPU tensors it runs the plain version (bf16 operands)."""
    kw = dict(num_encoding_fn_xyz=num_encoding_fn_xyz, log_sampling_xyz=log_sampling_xyz,
              small=small)
    check_samples(z_vals.shape[-1])
    check_bands(num_encoding_fn_xyz)
    if ray_origins.device.type == "cpu":
        return fused_paper_mlp_reference(bundle, ray_origins, ray_directions, z_vals, **kw)
    dev = _check_kernel_call("fused_paper_mlp_forward", ray_origins, ray_directions, z_vals,
                             num_encoding_fn_xyz)
    n_rays, n_samples = z_vals.shape
    operands = _kernel_operands(bundle, n_rays, dev, num_encoding_fn_xyz, log_sampling_xyz,
                                small, transposed=False)
    out = torch.empty(n_rays, n_samples, 4, dtype=torch.float32, device=dev)
    _launch_paper_fwd(operands, (ray_origins, ray_directions, z_vals), out, num_encoding_fn_xyz,
                      small)
    return out


fused_paper_mlp_forward.launches = 0


def _launch_paper_fwd(operands, per_ray, out, num_encoding_fn_xyz, small):
    """K3f's C entry point on checked CUDA operands: `operands` from
    `_kernel_operands(..., transposed=False)`, `per_ray` (ro, rd, z), `out`
    the (R, S, 4) f32 output. Counts the launch in
    `fused_paper_mlp_forward.launches`."""
    from nerface_tpu_torch.ops.kernels.build import layout_library

    dir_c, wbuf, fbuf, _ = operands
    ro, rd, z = per_ray
    n_rays, n_samples = z.shape
    lib = layout_library("fused_paper_mlp", n_samples, num_encoding_fn_xyz)
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = lib.nerface_fused_paper_mlp_fwd(
            _ptr(ro), _ptr(rd), _ptr(z), _ptr(dir_c), _ptr(wbuf), _ptr(fbuf), _ptr(out),
            n_rays, n_samples, num_encoding_fn_xyz, int(bool(small)), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_paper_mlp forward kernel launch failed: cudaError {err}")
    fused_paper_mlp_forward.launches += 1


def fused_paper_mlp_backward(
    bundle, ray_origins, ray_directions, z_vals, g, *, num_encoding_fn_xyz=10,
    log_sampling_xyz=True, small=False,
):
    """K3b: the f32 gradients, in the bundle's order and shapes, of
    Σ g·[rgb, σ] for g (R, S, 4). On CUDA tensors it launches
    `csrc/fused_paper_mlp.cu`'s pass (K1's wgmma pass kernel with K3b's
    middle, then dW; `csrc/paper_train.cuh`) or raises; on CPU tensors it runs the plain version (bf16 operands)."""
    kw = dict(num_encoding_fn_xyz=num_encoding_fn_xyz, log_sampling_xyz=log_sampling_xyz,
              small=small)
    check_samples(z_vals.shape[-1])
    check_bands(num_encoding_fn_xyz)
    if ray_origins.device.type == "cpu":
        return fused_paper_mlp_backward_reference(
            bundle, ray_origins, ray_directions, z_vals, g, **kw)
    dev = _check_kernel_call("fused_paper_mlp_backward", ray_origins, ray_directions, z_vals,
                             num_encoding_fn_xyz)
    n_rays, n_samples = z_vals.shape
    _check("g", g, (n_rays, n_samples, 4), dev)
    operands = _kernel_operands(bundle, n_rays, dev, num_encoding_fn_xyz, log_sampling_xyz,
                                small, transposed=True)
    out = paper_bwd_outputs(n_rays, dev, num_encoding_fn_xyz)
    ws = paper_bwd_workspace(n_rays, n_samples, dev, num_encoding_fn_xyz)
    _launch_paper_bwd(operands, (ray_origins, ray_directions, z_vals, g), out, ws,
                      num_encoding_fn_xyz, small)
    (d_cond0, d_cond3), gw, gb = _split_kernel_grads(out["dw"], out["df"],
                                                     6 * num_encoding_fn_xyz, small)
    # the operand buffers and the workspace may be freed on return: the
    # caching allocator hands their memory only to later work on this stream
    return _regroup(d_cond0, d_cond3, out["d_dir"], gw, gb, small)


def paper_bwd_outputs(n_rays: int, dev, num_encoding_fn_xyz: int = 10) -> Dict[str, torch.Tensor]:
    """K3b's uninitialised f32 outputs: the packed weight and row
    gradients (`w_layout(kx)` at the bands' extent / `F_LAYOUT`) and d_dir
    (R, 128)."""

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return {"dw": empty(w_offsets(xin_extent(num_encoding_fn_xyz))["TOTAL"]),
            "df": empty(F_OFFSETS["TOTAL"]), "d_dir": empty(n_rays, DIR_HIDDEN)}


def paper_bwd_workspace(n_rays: int, n_samples: int, dev, num_encoding_fn_xyz: int = 10) -> torch.Tensor:
    """K3b's device workspace for a pass (`csrc/paper_train.cuh`)."""
    from nerface_tpu_torch.ops.kernels.build import layout_library

    lib = layout_library("fused_paper_mlp", n_samples, num_encoding_fn_xyz)
    nbytes = lib.nerface_fused_paper_mlp_workspace_bytes(n_rays, n_samples, num_encoding_fn_xyz)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_paper_bwd(operands, per_ray, out, ws, num_encoding_fn_xyz, small):
    """K3b's C entry point on checked CUDA operands: `operands` from
    `_kernel_operands(..., transposed=True)`, `per_ray` (ro, rd, z, g),
    `out` from `paper_bwd_outputs`, `ws` from `paper_bwd_workspace`.
    Counts the launch in `fused_paper_mlp_backward.launches`."""
    from nerface_tpu_torch.ops.kernels.build import layout_library

    dir_c, wbuf, fbuf, wtbuf = operands
    ro, rd, z, g = per_ray
    n_rays, n_samples = z.shape
    lib = layout_library("fused_paper_mlp", n_samples, num_encoding_fn_xyz)
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = lib.nerface_fused_paper_mlp_bwd(
            _ptr(ro), _ptr(rd), _ptr(z), _ptr(dir_c), _ptr(g), _ptr(wbuf), _ptr(wtbuf),
            _ptr(fbuf), _ptr(out["dw"]), _ptr(out["df"]), _ptr(out["d_dir"]), _ptr(ws),
            n_rays, n_samples, num_encoding_fn_xyz, int(bool(small)), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_paper_mlp backward kernel launch failed: cudaError {err}")
    fused_paper_mlp_backward.launches += 1


fused_paper_mlp_backward.launches = 0


class FusedPaperMLP(torch.autograd.Function):
    """K3 with its VJP: `FusedPaperMLP.apply(opts, ro, rd, z, *bundle)`,
    opts = {num_encoding_fn_xyz, log_sampling_xyz, small, mm_dtype}. The
    forward saves only its inputs (the backward recomputes, as the TPU
    kernel's VJP does); the geometry gets no gradient. With bf16 operands
    the matrix gradients are rounded to bf16 (`fused_mlp.py:534-537`).
    `mm_dtype` f32 runs the plain version in f32 (CPU tensors only)."""

    @staticmethod
    def forward(ctx, opts, ro, rd, z, *bundle):
        kw = {k: opts[k] for k in ("num_encoding_fn_xyz", "log_sampling_xyz", "small")}
        ctx.kw, ctx.mm_dtype = kw, opts["mm_dtype"]
        ctx.save_for_backward(ro, rd, z, *bundle)
        with torch.no_grad():
            if ctx.mm_dtype == torch.bfloat16:
                return fused_paper_mlp_forward(bundle, ro, rd, z, **kw)
            if ro.device.type != "cpu":
                raise ValueError(f"the kernels take bf16 operands, not {ctx.mm_dtype}")
            return fused_paper_mlp_reference(bundle, ro, rd, z, mm_dtype=ctx.mm_dtype, **kw)

    @staticmethod
    def backward(ctx, g):
        ro, rd, z, *bundle = ctx.saved_tensors
        g = g.contiguous()
        if ctx.mm_dtype == torch.bfloat16:
            grads = fused_paper_mlp_backward(bundle, ro, rd, z, g, **ctx.kw)
            n_w = len(bundle_names(ctx.kw["small"])[0])
            grads = tuple(
                t.to(torch.bfloat16).float() if 3 <= i < 3 + n_w else t
                for i, t in enumerate(grads)
            )
        else:
            grads = fused_paper_mlp_backward_reference(
                bundle, ro, rd, z, g, mm_dtype=ctx.mm_dtype, **ctx.kw)
        return (None, None, None, None) + tuple(grads)


def fused_paper_mlp(
    bundle, ray_origins, ray_directions, z_vals, *, num_encoding_fn_xyz=10,
    log_sampling_xyz=True, small=False, mm_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Differentiable raw [rgb, σ] (R, S, 4) of the paper model's MLP
    (`fused_mlp.py::fused_paper_mlp`): `bundle` is
    `prefold_paper_params(...)` (all f32), whose gradients autograd carries
    back to the modules and the latent table. ro/rd (R, 3), z (R, S)."""
    opts = dict(num_encoding_fn_xyz=num_encoding_fn_xyz, log_sampling_xyz=log_sampling_xyz,
                small=small, mm_dtype=mm_dtype)
    return FusedPaperMLP.apply(opts, ray_origins, ray_directions, z_vals, *bundle)
