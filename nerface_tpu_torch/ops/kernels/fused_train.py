"""One training pass of the NeRFace paper model: radiance MLP forward,
volume compositing, the MSE-loss cotangent and the whole backward.

Port of K1, `nerface_tpu/ops/pallas/fused_train.py::fused_train_pass`
(TPU kernel `_train_kernel`, pallas_call at fused_train.py:398).

* `prefold_paper_params` is plain differentiable f32 torch: torch-layout
  params + the per-frame conditioning -> the kernel's input bundle
  (cond0, cond3, dir_contrib, 15 matrices (in, out), 10 bias rows), in
  the JAX package's order and shapes. Autograd carries the bundle's
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
  mirroring `fused_train.py:173-230` and `fused_mlp.py:248-330`: dW takes
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

from nerface_tpu_torch.ops.encoding import _frequency_bands
from nerface_tpu_torch.ops.kernels.fused_mlp import (
    DIR_HIDDEN,
    F_OFFSETS,
    HIDDEN,
    K_XIN,
    MAX_FREQS,
    W_OFFSETS,
    _check,
    _encode_points,
    pack_kernel_operands,
)

WEIGHT_NAMES = (
    "w0a", "w0b", "w1", "w2", "w3xa", "w3xb", "w3h", "w4", "w5", "wf", "wa",
    "wd0", "wd1", "wd2", "wrgb",
)
BIAS_NAMES = ("b1", "b2", "b4", "b5", "bf", "ba", "bd0", "bd1", "bd2", "brgb")
# S values the kernel is compiled for (whole rays per 128-row tile)
TRAIN_KERNEL_SAMPLES = (32, 64, 128)

# The trunk's transposed weights, (out, in) row-major, for the backward's
# dX products gy @ Wᵀ, in this order. They must equal WT_OFF_* in
# csrc/fused_train_pass.cu (a CPU test checks it).
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


def _wt_offsets():
    offs, o = {}, 0
    for name, k, n in WT_LAYOUT:
        offs[name] = o
        o += k * n
    offs["TOTAL"] = o
    return offs


WT_OFFSETS = _wt_offsets()


def prefold_paper_params(params, cond: torch.Tensor, pe_dir: torch.Tensor, num_encoding_fn_xyz: int):
    """Differentiable f32 map from the paper model's torch-layout params
    ({state-dict name: tensor}, e.g. `dict(model.named_parameters())`) and
    the per-frame cond = [expr/3; latent] to the kernel bundle (cond0 (1,
    256), cond3 (1, 256), dir_contrib (R, 128), *WEIGHT_NAMES (in, out),
    *BIAS_NAMES (1, out)) — `fused_train.py::prefold_paper_params`."""
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
    mats = (
        w("layers_xyz.0")[:, :3].T,
        w("layers_xyz.0")[:, 3:d_pe].T,
        w("layers_xyz.1").T,
        w("layers_xyz.2").T,
        w("layers_xyz.3")[:, :3].T,
        w("layers_xyz.3")[:, 3:d_pe].T,
        w("layers_xyz.3")[:, d_pe + dc:].T,
        w("layers_xyz.4").T,
        w("layers_xyz.5").T,
        w("fc_feat").T,
        w("fc_alpha").T,
        w("layers_dir.0")[:, :HIDDEN].T,
        w("layers_dir.1").T,
        w("layers_dir.2").T,
        w("fc_rgb").T,
    )
    biases = tuple(
        b(n)[None, :]
        for n in (
            "layers_xyz.1", "layers_xyz.2", "layers_xyz.4", "layers_xyz.5", "fc_feat",
            "fc_alpha", "layers_dir.0", "layers_dir.1", "layers_dir.2", "fc_rgb",
        )
    )
    return (cond0, cond3, dir_contrib) + mats + biases


def _unbundle(bundle):
    W = dict(zip(WEIGHT_NAMES, bundle[3:3 + len(WEIGHT_NAMES)]))
    B = dict(zip(BIAS_NAMES, bundle[3 + len(WEIGHT_NAMES):]))
    return bundle[0], bundle[1], bundle[2], W, B


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
    mm_dtype=torch.bfloat16,
):
    """Plain PyTorch version of `fused_train_pass` (same arguments and
    outputs), forward and hand-written backward. Returns (outs, grads,
    d_bg) with outs = {"rgb": (R, 3), "weights": (R, S)}, grads in the
    bundle's order and shapes, d_bg (R, 3) when `train_bg` else None."""
    cond0, cond3, dir_c, W, B = _unbundle([t.detach() for t in bundle])
    ro, rd, z, tgt = ray_origins, ray_directions, z_vals, target
    n_rays, n_samples = z.shape
    tile = n_rays * n_samples
    bf16 = mm_dtype != torch.float32

    def r(x):  # a matmul operand as the TPU kernel rounds it
        return x.to(mm_dtype).float() if bf16 else x

    Wr = {k: r(v) for k, v in W.items()}

    def dot(a, name):
        return r(a) @ Wr[name]

    # ---- forward (`fused_mlp.py::_trunk_forward`) ---------------------------
    x3 = (ro[:, None, :] + rd[:, None, :] * z[:, :, None]).reshape(-1, 3)
    enc = _encode_points(x3, num_encoding_fn_xyz, log_sampling_xyz)
    h0 = torch.relu(dot(x3, "w0a") + dot(enc, "w0b") + cond0)
    h1 = torch.relu(dot(h0, "w1") + B["b1"])
    h2 = torch.relu(dot(h1, "w2") + B["b2"])
    h3 = torch.relu(dot(x3, "w3xa") + dot(enc, "w3xb") + dot(h2, "w3h") + cond3)
    h4 = torch.relu(dot(h3, "w4") + B["b4"])
    h5 = torch.relu(dot(h4, "w5") + B["b5"])
    feat = dot(h5, "wf") + B["bf"]
    sigma = (dot(feat, "wa") + B["ba"]).reshape(n_rays, n_samples)
    hd_pre = ((dot(feat, "wd0") + B["bd0"]).reshape(n_rays, n_samples, DIR_HIDDEN)
              + dir_c[:, None, :]).reshape(tile, DIR_HIDDEN)
    x0 = torch.relu(hd_pre)
    x1 = torch.relu(dot(x0, "wd1") + B["bd1"])
    x2 = torch.relu(dot(x1, "wd2") + B["bd2"])
    rgb_raw = (dot(x2, "wrgb") + B["brgb"]).reshape(n_rays, n_samples, 3)
    # activations kept for the backward: bf16 on the TPU kernel
    a = {k: r(v) for k, v in dict(h0=h0, h1=h1, h2=h2, h3=h3, h4=h4, h5=h5, feat=feat,
                                  hd_pre=hd_pre, x1=x1, x2=x2).items()}

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
    g_rgb = g_rgb_raw.reshape(tile, 3)
    g_alpha = g_sigma.reshape(tile, 1)

    def dot_t(x, gy):  # dW = xᵀ gy
        return r(x).T @ r(gy)

    def dot_bt(gy, name):  # dx = gy Wᵀ
        return r(gy) @ Wr[name].T

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
    gh5 = dot_bt(gfeat, "wf") * m(a["h5"])
    gw["w5"] = dot_t(a["h4"], gh5)
    gb["b5"] = gh5.sum(0, keepdim=True)
    gh4 = dot_bt(gh5, "w5") * m(a["h4"])
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

    grads = (d_cond0, d_cond3, d_dir) + tuple(gw[n] for n in WEIGHT_NAMES) + tuple(
        gb[n] for n in BIAS_NAMES
    )
    outs = {"rgb": rgb_map, "weights": weights}
    return outs, grads, (g_bg if train_bg else None)


def pack_transposed_weights(W) -> torch.Tensor:
    """The dX products' bf16 operand buffer: `WT_LAYOUT`'s matrices, each
    the (in, out) kernel-layout matrix transposed to (out, in)."""
    return torch.cat(
        [W[WT_SOURCE[name]].T.reshape(-1) for name, *_ in WT_LAYOUT]
    ).to(torch.bfloat16).contiguous()


def _split_kernel_grads(dwbuf, dfbuf, n_enc):
    """The kernel's packed f32 gradients -> the bundle's weight and bias
    gradients; the zero-padded rows of W0/W3 are dropped."""

    def mat(name, rows, cols):
        o = W_OFFSETS[name]
        return dwbuf[o:o + rows * cols].reshape(rows, cols)

    w0 = mat("W0", K_XIN, HIDDEN)
    w3 = mat("W3", K_XIN + HIDDEN, HIDDEN)
    gw = {
        "w0a": w0[:3], "w0b": w0[3:3 + n_enc], "w1": mat("W1", HIDDEN, HIDDEN),
        "w2": mat("W2", HIDDEN, HIDDEN), "w3xa": w3[:3], "w3xb": w3[3:3 + n_enc],
        "w3h": w3[K_XIN:], "w4": mat("W4", HIDDEN, HIDDEN), "w5": mat("W5", HIDDEN, HIDDEN),
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
    return (row("COND0", HIDDEN), row("COND3", HIDDEN)), gw, gb


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
):
    """One training pass (coarse or fine) through the fused kernel: the
    JAX package's arguments and outputs (`fused_train.py:293-318`, without
    `small`). `bundle` is `prefold_paper_params(...)` (all f32). Returns
    (outs, grads, d_bg): outs = {"rgb": (R, 3), "weights": (R, S)}, grads
    the f32 gradients in the bundle's order and shapes, d_bg (R, 3) when
    `train_bg` else None."""
    n_rays, n_samples = z_vals.shape
    if noise_std > 0.0 and noise is None:
        raise ValueError("noise_std > 0 requires a noise array")
    if (sup_bg_scale > 0.0 or train_bg) and background is None:
        raise ValueError("sup_bg_scale > 0 and train_bg need a background")
    if len(bundle) != 3 + len(WEIGHT_NAMES) + len(BIAS_NAMES):
        raise ValueError(f"bundle has {len(bundle)} tensors, expected 28")
    kw = dict(
        background=background, noise=noise, noise_std=noise_std,
        white_background=white_background, loss_scale=loss_scale, sup_bg_scale=sup_bg_scale,
        train_bg=train_bg, num_encoding_fn_xyz=num_encoding_fn_xyz,
        log_sampling_xyz=log_sampling_xyz,
    )
    dev = ray_origins.device
    if dev.type == "cpu":
        return fused_train_pass_reference(bundle, ray_origins, ray_directions, z_vals, target, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_train_pass runs on cuda or cpu, not {dev}")
    if n_samples not in TRAIN_KERNEL_SAMPLES:
        raise ValueError(
            f"kernel is built for {TRAIN_KERNEL_SAMPLES} samples per ray, got {n_samples}"
        )
    if not 1 <= num_encoding_fn_xyz <= MAX_FREQS:
        raise ValueError(f"kernel takes 1..{MAX_FREQS} xyz encoding bands")
    n_enc = 6 * num_encoding_fn_xyz
    _check("ray_origins", ray_origins, (n_rays, 3), dev)
    _check("ray_directions", ray_directions, (n_rays, 3), dev)
    _check("z_vals", z_vals, (n_rays, n_samples), dev)
    _check("target", target, (n_rays, 3), dev)
    if background is not None:
        _check("background", background, (n_rays, 3), dev)
    if noise_std > 0.0:
        _check("noise", noise, (n_rays, n_samples), dev)
    bundle = [t.detach() for t in bundle]
    cond0, cond3, dir_c, W, B = _unbundle(bundle)
    _check("dir_contrib", dir_c, (n_rays, DIR_HIDDEN), dev)
    _check("cond0", cond0, (1, HIDDEN), dev)
    _check("cond3", cond3, (1, HIDDEN), dev)
    shapes = {"w0a": (3, HIDDEN), "w0b": (n_enc, HIDDEN), "w3xa": (3, HIDDEN),
              "w3xb": (n_enc, HIDDEN), "wa": (HIDDEN, 1), "wd0": (HIDDEN, DIR_HIDDEN),
              "wd1": (DIR_HIDDEN, DIR_HIDDEN), "wd2": (DIR_HIDDEN, DIR_HIDDEN),
              "wrgb": (DIR_HIDDEN, 3)}
    for name, t in W.items():
        want = shapes.get(name, (HIDDEN, HIDDEN))
        if t.dtype != torch.float32 or tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"{name} must be float32 {want} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in B.items():
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 1 or t.device != dev:
            raise ValueError(f"{name} must be a float32 (1, n) row on {dev}")

    freqs = torch.as_tensor(_frequency_bands(num_encoding_fn_xyz, log_sampling_xyz), device=dev)
    Wk = dict(W)
    Wk.update({k: v.reshape(-1) for k, v in B.items()})
    wbuf, fbuf = pack_kernel_operands(cond0.reshape(-1), cond3.reshape(-1), Wk, freqs)
    wtbuf = pack_transposed_weights(W)

    from nerface_tpu_torch.ops.kernels.build import load_library

    lib = load_library("fused_train_pass")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    rgb, weights = empty(n_rays, 3), empty(n_rays, n_samples)
    dwbuf, dfbuf = empty(W_OFFSETS["TOTAL"]), empty(F_OFFSETS["TOTAL"])
    d_dir = empty(n_rays, DIR_HIDDEN)
    d_bg = empty(n_rays, 3) if train_bg else None
    ws = torch.empty(
        lib.nerface_fused_train_workspace_bytes(n_rays, n_samples), dtype=torch.uint8, device=dev
    )

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerface_fused_train_pass(
            ptr(ray_origins), ptr(ray_directions), ptr(z_vals), ptr(target), ptr(dir_c),
            ptr(background), ptr(noise if noise_std > 0.0 else None),
            ptr(wbuf), ptr(wtbuf), ptr(fbuf),
            ptr(rgb), ptr(weights), ptr(dwbuf), ptr(dfbuf), ptr(d_dir), ptr(d_bg), ptr(ws),
            n_rays, n_samples, num_encoding_fn_xyz, int(bool(white_background)),
            ctypes.c_float(noise_std), ctypes.c_float(loss_scale), ctypes.c_float(sup_bg_scale),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_train_pass kernel launch failed: cudaError {err}")
    fused_train_pass.launches += 1
    (d_cond0, d_cond3), gw, gb = _split_kernel_grads(dwbuf, dfbuf, n_enc)
    grads = (d_cond0, d_cond3, d_dir) + tuple(gw[n] for n in WEIGHT_NAMES) + tuple(
        gb[n] for n in BIAS_NAMES
    )
    # the operand buffers and the workspace may be freed on return: the
    # caching allocator hands their memory only to later work on this stream
    return {"rgb": rgb, "weights": weights}, grads, d_bg


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
