"""One training pass of the NeRFace paper model: radiance MLP forward,
volume compositing, the MSE-loss cotangent and the whole backward.

Port of K1, `nerface_tpu/ops/pallas/fused_train.py::fused_train_pass`
(TPU kernel `_train_kernel`, pallas_call at fused_train.py:398).

* `prefold_paper_params` is plain differentiable f32 torch: torch-layout
  params + the per-frame conditioning -> the kernel's input bundle
  (cond0, cond3, dir_contrib, 15 matrices (in, out), 10 bias rows; 14
  and 9 for the smaller model, `small`), in the JAX package's order and
  shapes. K3 (`fused_mlp.py::fused_paper_mlp`) takes the same bundle. Autograd carries the bundle's
  gradients back to the modules, the latent table and a trainable
  background.
* `fused_train_pass` is the wrapper: on CUDA tensors it launches the
  hand-written kernels of `csrc/fused_train_pass.cu` or raises; on CPU
  tensors it runs `fused_train_pass_reference`. It counts one launch per
  call in `fused_train_pass.launches`.
* `fused_train_pass_reference` is the plain PyTorch version. Its forward
  rounds to bf16 where the TPU kernel does (`mm_dtype=torch.bfloat16`:
  every left matmul operand, the raw points included, and the weights);
  its compositing backward and trunk backward are written out by hand,
  mirroring `fused_train.py:173-230` and `fused_mlp.py:248-330` (the
  trunk's forward and backward are K3's, `fused_mlp.py::
  _trunk_forward_reference` / `_trunk_backward_reference`): dW takes
  bf16 activations and a bf16-rounded cotangent, dX rounds the cotangent,
  relu masks are taken on the bf16 activations, bias sums take the f32
  cotangents. With `mm_dtype=torch.float32` it is the f32 math, equal to
  torch autograd of the same forward.
* `FusedTrainPass` is the `torch.autograd.Function` around either: its
  forward returns the pass's scalar loss (MSE, plus the supervised
  background term when `sup_bg_scale` > 0) with `rgb` and `weights`
  (non-differentiable); its backward hands `grad_output ×` the pass's
  gradients to the bundle and the background.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from nerface_tpu_torch.ops.kernels.fused_mlp import (
    DIR_HIDDEN,
    F_OFFSETS,
    HIDDEN,
    ITEM_ROWS,
    K_XIN,
    _check,
    _check_kernel_call,
    _encode_points,
    _kernel_operands,
    _points,
    _ptr,
    _regroup,
    _split_kernel_grads,
    _trunk_backward_reference,
    _trunk_forward_reference,
    _unbundle,
    bundle_names,
    check_bands,
    check_samples,
    unit_layout,
    w_offsets,
    xin_extent,
)


# The device workspace of a K1 / K3b call (csrc/paper_train.cuh, `WsBuffer`
# and `carve`): these bf16 buffers in this order, each one matrix of the
# pass (sample rows × width) as wgmma operand images (`workspace_image`),
# xin's width the pass's encoding extent kx (`xin_extent`), then each
# consumer warp's and each CTA's f32 partial row (PART_COLS: the bias rows,
# WA, WRGB) and dW's DWG_SEGS row segments (`w_offsets(kx)["WA"]` columns),
# then a long item's rows (`item_row_floats`); every piece aligned to 256
# bytes (`workspace_layout`). A CPU test holds these to the .cuh.
def ws_buffers(kx: int = K_XIN):
    """(name, width) of the workspace's bf16 buffers at encoding extent kx."""
    return (
        ("xin", kx), ("h0", HIDDEN), ("h1", HIDDEN), ("h2", HIDDEN), ("h3", HIDDEN),
        ("h4", HIDDEN), ("h5", HIDDEN), ("feat", HIDDEN), ("x0", DIR_HIDDEN), ("x1", DIR_HIDDEN),
        ("x2", DIR_HIDDEN), ("gx2", DIR_HIDDEN), ("gx1", DIR_HIDDEN), ("gx0", DIR_HIDDEN),
        ("gfeat", HIDDEN), ("gh0", HIDDEN), ("gh1", HIDDEN), ("gh2", HIDDEN), ("gh3", HIDDEN),
        ("gh4", HIDDEN), ("gh5", HIDDEN),
    )


WS_BUFFERS = ws_buffers(K_XIN)
K1_CTAS = 132  # the persistent grid's CTAs at most
WARPS_A_CTA = 8  # consumer warps of a CTA
DWG_SEGS = 7  # dW's row segments
PART_COLS = F_OFFSETS["TOTAL"] + HIDDEN + DIR_HIDDEN * 3


def workspace_geometry(n_rays: int, n_samples: int) -> Tuple[int, int]:
    """(64-row units, persistent CTAs) of a pass: a consumer warpgroup's
    item is `unit_layout(S)`'s rays in its units (64 // S rays in one unit
    at S = 32, one ray of S // 64 units at 64 and 128)."""
    per_item, units_an_item = unit_layout(n_samples)
    items = -(-n_rays // per_item)
    return items * units_an_item, min(-(-items // 2), K1_CTAS)


def item_row_floats(units_an_item: int) -> int:
    """The f32 values of a long item's rows slab (`item_row_floats` in
    csrc/paper_train.cuh): raw σ, rgb and their cotangents, 8 a row, for an
    item past ITEM_ROWS rows (S > 256, one ray); 0 for a shorter item, whose
    rows stay in shared memory."""
    return 8 * 64 * units_an_item if units_an_item * 64 > ITEM_ROWS else 0


def workspace_layout(n_rays: int, n_samples: int, kx: int = K_XIN) -> dict:
    """{piece: (byte offset, bytes)} of a K1 / K3b call's workspace, as
    csrc/paper_train.cuh's `carve` lays it out: the bf16 buffers of
    `ws_buffers(kx)` (`units` 64-row unit images each), "warp_part",
    "tile_part", "dw_part", "rows" (the long items' slabs, one a consumer
    warpgroup of each CTA), each at a multiple of 256 bytes; "total" the
    bytes of the whole (`nerface_fused_train_workspace_bytes`)."""
    units, ctas = workspace_geometry(n_rays, n_samples)
    _, units_an_item = unit_layout(n_samples)
    pieces = [(name, units * width * 128) for name, width in ws_buffers(kx)]
    pieces += [("warp_part", ctas * WARPS_A_CTA * PART_COLS * 4), ("tile_part", ctas * PART_COLS * 4),
               ("dw_part", DWG_SEGS * w_offsets(kx)["WA"] * 4),
               ("rows", ctas * 2 * item_row_floats(units_an_item) * 4)]
    out, off = {}, 0
    for name, n in pieces:
        out[name] = (off, n)
        off = -(-(off + n) // 256) * 256
    out["total"] = off
    return out


def workspace_image(m: torch.Tensor) -> torch.Tensor:
    """A (rows, width) matrix (rows a multiple of 64, width of 64) as the
    workspace holds it, flat: for each 64-row unit, its 64-column blocks
    of 64 rows, row r's eight 16-byte groups at position group ^ (r % 8) —
    element (r, c) of unit u at byte u·width·128 + (c // 64)·8192 +
    r·128 + (((c % 64) // 8) ^ (r % 8))·16 + (c % 8)·2 (`image_offset`)."""
    rows, width = m.shape
    t = m.reshape(rows // 64, 64, width // 64, 8, 8).permute(0, 2, 1, 3, 4)
    r = torch.arange(64, device=m.device)[:, None]
    slot = torch.arange(8, device=m.device)[None, :]
    return t[:, :, r, slot ^ (r % 8), :].reshape(-1).contiguous()


def prefold_paper_params(params, cond: torch.Tensor, pe_dir: torch.Tensor, num_encoding_fn_xyz: int,
                         small: bool = False, dir_expr_offset: int = 0):
    """Differentiable f32 map from the paper model's torch-layout params
    ({state-dict name: tensor}, e.g. `dict(model.named_parameters())`) and
    the per-frame cond = [expr/3; latent] to the kernel bundle (cond0 (1,
    256), cond3 (1, 256), dir_contrib (R, 128), the matrices (in, out), the
    bias rows (1, out); `bundle_names(small)`) —
    `fused_train.py::prefold_paper_params`. With `small` the smaller model
    is laid out (no layers_xyz.5), and a nonzero `dir_expr_offset` (the
    column of layers_dir.0 where its expression block starts: 256 + the
    declared dir width) folds the expression part of `cond` into
    dir_contrib: the smaller model's direction branch reads [feat; dirs;
    expr/3]."""
    d_pe = 3 + 6 * num_encoding_fn_xyz
    dc = cond.shape[-1]

    def w(name):
        return params[name + ".weight"]

    def b(name):
        return params[name + ".bias"]

    cond0 = (w("layers_xyz.0")[:, d_pe:d_pe + dc] @ cond + b("layers_xyz.0"))[None, :]
    cond3 = (w("layers_xyz.3")[:, d_pe:d_pe + dc] @ cond + b("layers_xyz.3"))[None, :]
    dd = pe_dir.shape[-1]
    dir_contrib = pe_dir @ w("layers_dir.0")[:, HIDDEN:HIDDEN + dd].T
    if dir_expr_offset:
        # the per-frame expression: one (128,) vector added to every ray
        n_expr = dc - 32  # cond is [expr/3; latent (32)]
        dir_contrib = dir_contrib + (
            w("layers_dir.0")[:, dir_expr_offset:dir_expr_offset + n_expr] @ cond[:n_expr]
        )
    wn, bn = bundle_names(small)
    mats = {
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
    }
    biases = {
        "b1": "layers_xyz.1", "b2": "layers_xyz.2", "b4": "layers_xyz.4", "bf": "fc_feat",
        "ba": "fc_alpha", "bd0": "layers_dir.0", "bd1": "layers_dir.1", "bd2": "layers_dir.2",
        "brgb": "fc_rgb",
    }
    if not small:
        mats["w5"], biases["b5"] = w("layers_xyz.5").T, "layers_xyz.5"
    return ((cond0, cond3, dir_contrib) + tuple(mats[n] for n in wn)
            + tuple(b(biases[n])[None, :] for n in bn))


def fused_train_pass_reference(
    bundle: Sequence[torch.Tensor],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    z_vals: torch.Tensor,
    target: torch.Tensor,
    *,
    background: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    white_background: bool = False,
    loss_scale: float,
    sup_bg_scale: float = 0.0,
    train_bg: bool = False,
    num_encoding_fn_xyz: int = 10,
    log_sampling_xyz: bool = True,
    small: bool = False,
    mm_dtype=torch.bfloat16,
):
    """Plain PyTorch version of `fused_train_pass` (same arguments and
    outputs), forward and hand-written backward. Returns (outs, grads,
    d_bg) with outs = {"rgb": (R, 3), "weights": (R, S)}, grads in the
    bundle's order and shapes, d_bg (R, 3) when `train_bg` else None."""
    cond0, cond3, dir_c, W, B = _unbundle([t.detach() for t in bundle], small)
    W.update(B)
    ro, rd, z, tgt = ray_origins, ray_directions, z_vals, target
    n_rays, n_samples = z.shape
    tile = n_rays * n_samples

    # ---- forward (`fused_mlp.py::_trunk_forward`) ---------------------------
    x3 = _points(ro, rd, z)
    enc = _encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz)
    rgb_raw, sigma, a = _trunk_forward_reference(
        W, cond0, cond3, dir_c, x3, enc, n_rays, n_samples, mm_dtype)

    # ---- compositing (`fused_train.py:122-171`) -----------------------------
    d = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    d = d * torch.sqrt(torch.sum(rd * rd, dim=-1, keepdim=True))
    is_last = torch.zeros(n_rays, n_samples, dtype=torch.bool, device=z.device)
    is_last[:, -1] = True
    m_last = is_last.float()
    sig = torch.sigmoid(rgb_raw)
    has_bg = background is not None
    rgb_act = sig
    if has_bg:
        rgb_act = torch.cat([sig[:, :-1], background[:, None, :]], dim=1)
    sigma_n = sigma + noise * noise_std if noise_std > 0.0 else sigma
    relu_mask = (sigma_n > 0.0).float()
    sigma_a = sigma_n * relu_mask + m_last * 1e-6
    one_minus_alpha = torch.exp(-sigma_a * d)
    alpha = 1.0 - one_minus_alpha
    log_t = torch.log(one_minus_alpha + 1e-10)
    trans = torch.exp(
        torch.cat([torch.zeros_like(log_t[:, :1]), torch.cumsum(log_t[:, :-1], dim=-1)], dim=-1)
    )
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb_act, dim=1)
    if white_background:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=1, keepdim=True))

    # ---- loss cotangent and compositing backward (`fused_train.py:173-221`)
    g_rgb_map = (rgb_map - tgt) * loss_scale
    g_w = torch.sum(rgb_act * g_rgb_map[:, None, :], dim=-1)
    if white_background:
        g_w = g_w - torch.sum(g_rgb_map, dim=-1, keepdim=True)
    g_bg_sup = None
    if sup_bg_scale > 0.0:
        diff_bg = background - tgt
        per_ray = torch.sum(diff_bg * diff_bg, dim=-1, keepdim=True)
        g_w = g_w + per_ray * sup_bg_scale * m_last
        if train_bg:
            g_bg_sup = 2.0 * diff_bg * weights[:, -1:] * sup_bg_scale
    g_rgb_act = weights[..., None] * g_rgb_map[:, None, :]
    g_alpha_c = g_w * trans
    g_trans = g_w * alpha
    # g_log_t_j = Σ_{i>j} g_trans_i·trans_i: an exclusive suffix sum
    v = g_trans * trans
    suffix = torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1])
    g_log_t = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=1)
    g_omae = g_log_t / (one_minus_alpha + 1e-10) - g_alpha_c
    # multiply by omae first: it is exactly 0 on the 1e10 last distance
    g_sigma = (-(one_minus_alpha * g_omae) * d) * relu_mask
    g_sig = g_rgb_act * sig * (1.0 - sig)
    g_bg = None
    if has_bg:
        g_rgb_raw = torch.cat([g_sig[:, :-1], torch.zeros_like(g_sig[:, -1:])], dim=1)
        g_bg = g_rgb_act[:, -1]
        if g_bg_sup is not None:
            g_bg = g_bg + g_bg_sup
    else:
        g_rgb_raw = g_sig

    # ---- trunk backward (`fused_mlp.py:248-330`) ---------------------------
    gw, gb, d_cond0, d_cond3, d_dir = _trunk_backward_reference(
        W, a, x3, enc, g_rgb_raw.reshape(tile, 3), g_sigma.reshape(tile, 1), n_rays, n_samples,
        mm_dtype)
    grads = _regroup(d_cond0, d_cond3, d_dir, gw, gb, small)
    outs = {"rgb": rgb_map, "weights": weights}
    return outs, grads, (g_bg if train_bg else None)


def fused_train_pass(
    bundle: Sequence[torch.Tensor],
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    z_vals: torch.Tensor,
    target: torch.Tensor,
    *,
    background: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    white_background: bool = False,
    loss_scale: float,
    sup_bg_scale: float = 0.0,
    train_bg: bool = False,
    num_encoding_fn_xyz: int = 10,
    log_sampling_xyz: bool = True,
    small: bool = False,
):
    """One training pass (coarse or fine) through the fused kernel: the
    JAX package's arguments and outputs (`fused_train.py:293-318`).
    `bundle` is `prefold_paper_params(...)` (all f32; the smaller model's
    with `small`). Returns (outs, grads, d_bg): outs = {"rgb": (R, 3),
    "weights": (R, S)}, grads the f32 gradients in the bundle's order and
    shapes, d_bg (R, 3) when `train_bg` else None."""
    n_rays, n_samples = z_vals.shape
    check_samples(n_samples)
    check_bands(num_encoding_fn_xyz)
    if noise_std > 0.0 and noise is None:
        raise ValueError("noise_std > 0 requires a noise array")
    if (sup_bg_scale > 0.0 or train_bg) and background is None:
        raise ValueError("sup_bg_scale > 0 and train_bg need a background")
    kw = dict(
        background=background, noise=noise, noise_std=noise_std,
        white_background=white_background, loss_scale=loss_scale, sup_bg_scale=sup_bg_scale,
        train_bg=train_bg, num_encoding_fn_xyz=num_encoding_fn_xyz,
        log_sampling_xyz=log_sampling_xyz, small=small,
    )
    if ray_origins.device.type == "cpu":
        return fused_train_pass_reference(bundle, ray_origins, ray_directions, z_vals, target, **kw)
    dev = _check_kernel_call("fused_train_pass", ray_origins, ray_directions, z_vals,
                             num_encoding_fn_xyz)
    _check("target", target, (n_rays, 3), dev)
    if background is not None:
        _check("background", background, (n_rays, 3), dev)
    if noise_std > 0.0:
        _check("noise", noise, (n_rays, n_samples), dev)
    operands = _kernel_operands(bundle, n_rays, dev, num_encoding_fn_xyz, log_sampling_xyz,
                                small, transposed=True)
    out = train_outputs(n_rays, n_samples, train_bg, dev, num_encoding_fn_xyz)
    ws = train_workspace(n_rays, n_samples, dev, num_encoding_fn_xyz)
    _launch_train(operands, (ray_origins, ray_directions, z_vals, target, background,
                             noise if noise_std > 0.0 else None), out, ws,
                  num_encoding_fn_xyz=num_encoding_fn_xyz, white_background=white_background,
                  small=small, noise_std=noise_std, loss_scale=loss_scale,
                  sup_bg_scale=sup_bg_scale)
    (d_cond0, d_cond3), gw, gb = _split_kernel_grads(out["dw"], out["df"],
                                                     6 * num_encoding_fn_xyz, small)
    grads = _regroup(d_cond0, d_cond3, out["d_dir"], gw, gb, small)
    # the operand buffers and the workspace may be freed on return: the
    # caching allocator hands their memory only to later work on this stream
    return {"rgb": out["rgb"], "weights": out["weights"]}, grads, out["d_bg"]


def train_outputs(n_rays: int, n_samples: int, train_bg: bool, dev,
                  num_encoding_fn_xyz: int = 10) -> dict:
    """K1's uninitialised f32 outputs: rgb (R, 3), weights (R, S), the
    packed weight and row gradients (`w_offsets(kx)` at the bands' extent /
    `F_OFFSETS`), d_dir (R, 128), and d_bg (R, 3) with `train_bg` (else
    None)."""

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return {"rgb": empty(n_rays, 3), "weights": empty(n_rays, n_samples),
            "dw": empty(w_offsets(xin_extent(num_encoding_fn_xyz))["TOTAL"]),
            "df": empty(F_OFFSETS["TOTAL"]),
            "d_dir": empty(n_rays, DIR_HIDDEN), "d_bg": empty(n_rays, 3) if train_bg else None}


def train_workspace(n_rays: int, n_samples: int, dev, num_encoding_fn_xyz: int = 10) -> torch.Tensor:
    """K1's device workspace for a pass (`ws_buffers`, csrc/paper_train.cuh)."""
    from nerface_tpu_torch.ops.kernels.build import layout_library

    lib = layout_library("fused_train_pass", n_samples, num_encoding_fn_xyz)
    nbytes = lib.nerface_fused_train_workspace_bytes(n_rays, n_samples, num_encoding_fn_xyz)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_train(operands, per_ray, out, ws, *, num_encoding_fn_xyz, white_background, small,
                  noise_std, loss_scale, sup_bg_scale):
    """K1's C entry point on checked CUDA operands: `operands` from
    `_kernel_operands(..., transposed=True)`, `per_ray` (ro, rd, z,
    target, background or None, noise or None), `out` from
    `train_outputs`, `ws` from `train_workspace`. Counts the launch in
    `fused_train_pass.launches`."""
    from nerface_tpu_torch.ops.kernels.build import layout_library

    dir_c, wbuf, fbuf, wtbuf = operands
    ro, rd, z, tgt, bg, noise = per_ray
    n_rays, n_samples = z.shape
    lib = layout_library("fused_train_pass", n_samples, num_encoding_fn_xyz)
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = lib.nerface_fused_train_pass(
            _ptr(ro), _ptr(rd), _ptr(z), _ptr(tgt), _ptr(dir_c), _ptr(bg), _ptr(noise),
            _ptr(wbuf), _ptr(wtbuf), _ptr(fbuf),
            _ptr(out["rgb"]), _ptr(out["weights"]), _ptr(out["dw"]), _ptr(out["df"]),
            _ptr(out["d_dir"]), _ptr(out["d_bg"]), _ptr(ws),
            n_rays, n_samples, num_encoding_fn_xyz, int(bool(white_background)), int(bool(small)),
            ctypes.c_float(noise_std), ctypes.c_float(loss_scale), ctypes.c_float(sup_bg_scale),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_train_pass kernel launch failed: cudaError {err}")
    fused_train_pass.launches += 1


fused_train_pass.launches = 0


class FusedTrainPass(torch.autograd.Function):
    """Differentiable training pass: `FusedTrainPass.apply(opts,
    background, *bundle)` with opts the dict of `fused_train_pass`'s other
    arguments (ray_origins, ray_directions, z_vals, target, noise, ...).
    Returns (loss, rgb, weights, mse, bg_loss): mse = mean((rgb −
    target)²), bg_loss = mean(Σ_c (bg − target)² · w_last)·0.001 when
    opts["sup_bg_scale"] > 0 (else 0), loss = mse + bg_loss; only loss is
    differentiable. The background gets a gradient when opts["train_bg"]."""

    @staticmethod
    def forward(ctx, opts, background, *bundle):
        kw = dict(opts)
        ro, rd, z, tgt = (kw.pop(k) for k in
                          ("ray_origins", "ray_directions", "z_vals", "target"))
        with torch.no_grad():
            outs, grads, d_bg = fused_train_pass(
                bundle, ro, rd, z, tgt, background=None if background is None else
                background.detach(), **kw
            )
            rgb, weights = outs["rgb"], outs["weights"]
            mse = torch.mean((rgb - tgt) ** 2)
            bg_loss = mse.new_zeros(())
            if kw.get("sup_bg_scale", 0.0) > 0.0:
                per_ray = torch.sum((background.detach() - tgt) ** 2, dim=-1)
                bg_loss = torch.mean(per_ray * weights[:, -1]) * 0.001
            loss = mse + bg_loss  # a tensor of its own: mse is not differentiable
        ctx.save_for_backward(*grads, *(() if d_bg is None else (d_bg,)))
        ctx.has_bg_grad = d_bg is not None
        ctx.mark_non_differentiable(rgb, weights, mse, bg_loss)
        return loss, rgb, weights, mse, bg_loss

    @staticmethod
    def backward(ctx, g_loss, *_):
        saved = ctx.saved_tensors
        if ctx.has_bg_grad:
            grads, d_bg = saved[:-1], saved[-1] * g_loss
        else:
            grads, d_bg = saved, None
        return (None, d_bg) + tuple(g * g_loss for g in grads)


def fused_train_loss(
    bundle, ray_origins, ray_directions, z_vals, target, *, background=None, **kw
) -> Tuple[torch.Tensor, ...]:
    """(loss, rgb, weights, mse, bg_loss) of one pass through
    `FusedTrainPass`; `kw` are `fused_train_pass`'s keyword arguments."""
    opts = dict(kw, ray_origins=ray_origins, ray_directions=ray_directions, z_vals=z_vals,
                target=target)
    return FusedTrainPass.apply(opts, background, *bundle)
