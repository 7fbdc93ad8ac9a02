"""Occupancy-grid ray skipping: the 3D upgrade of fast-eval's 2D bbox.

Port of `nerface_tpu/eval/occupancy.py`. A boolean voxel grid marks where
the trained field has density; a ray whose test finds no occupied voxel
composites straight to the background on the fast path
(`eval/renderer.py`), and the rays kept ride the same capacity packing as
the bbox. Everything here is plain PyTorch: the grid build is the model's
plain forward over voxel centres in chunks (a large matmul chain, as it is
plain XLA in JAX), the masks are gathers or a splat into a difference array.

The conservativeness knobs (σ threshold, dilation, probe count, the 2×
supersampled build of the splat mode) default to over-inclusion: a false
positive voxel costs a few rendered rays; a false negative would clip the
face. A grid saved by either package (`save`: `.npz` with `grid`, `lo`,
`hi`) loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nerface_tpu_torch.ops.math import linspace01
from nerface_tpu_torch.ops.rays import get_ray_bundle


@dataclasses.dataclass
class OccupancyGrid:
    """Boolean voxel grid over a world-space AABB, on one device.

    `boxes_lo/boxes_hi/boxes_valid` (set by `with_boxes()`) are the
    occupied voxels as a padded list of world AABBs, the input of the
    projection-splat ray mask (`ray_occupancy_mask_splat`)."""

    grid: torch.Tensor      # (R, R, R) bool
    aabb_lo: torch.Tensor   # (3,) f32
    aabb_hi: torch.Tensor   # (3,) f32
    boxes_lo: Optional[torch.Tensor] = None     # (K, 3) f32
    boxes_hi: Optional[torch.Tensor] = None     # (K, 3) f32
    boxes_valid: Optional[torch.Tensor] = None  # (K,) bool

    @property
    def resolution(self) -> int:
        return int(self.grid.shape[0])

    def occupancy_fraction(self) -> float:
        return float(self.grid.float().mean())

    def with_boxes(self, round_to: int = 1024) -> "OccupancyGrid":
        """Attach the occupied voxels' world boxes, merged into runs along
        the grid's z axis (adjacent occupied voxels of one column share a
        box), padded to a multiple of `round_to` (host numpy, as in JAX)."""
        g = self.grid.cpu().numpy().astype(bool)
        res = g.shape
        lo3 = self.aabb_lo.cpu().numpy().astype(np.float32)
        hi3 = self.aabb_hi.cpu().numpy().astype(np.float32)
        vox = (hi3 - lo3) / np.asarray(res, np.float32)
        # run-length merge along axis 2: starts where 0 -> 1, ends at 1 -> 0
        z = np.zeros((*res[:2], 1), np.int8)
        d = np.diff(np.concatenate([z, g.astype(np.int8), z], 2), axis=2)
        starts = np.argwhere(d == 1)
        ends = np.argwhere(d == -1)
        # argwhere is lexicographic in (x, y, z) and runs do not overlap, so
        # starts and ends pair up within each (x, y) column
        blo = lo3 + starts.astype(np.float32) * vox
        bhi = lo3 + (ends + np.array([1, 1, 0])).astype(np.float32) * vox
        k = len(starts)
        cap = max(round_to, ((k + round_to - 1) // round_to) * round_to)
        blo = np.pad(blo, ((0, cap - k), (0, 0)))
        bhi = np.pad(bhi, ((0, cap - k), (0, 0)))
        valid = np.zeros(cap, bool)
        valid[:k] = True
        dev = self.grid.device
        return dataclasses.replace(
            self, boxes_lo=torch.from_numpy(blo.astype(np.float32)).to(dev),
            boxes_hi=torch.from_numpy(bhi.astype(np.float32)).to(dev),
            boxes_valid=torch.from_numpy(valid).to(dev),
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, grid=self.grid.cpu().numpy(), lo=self.aabb_lo.cpu().numpy(),
            hi=self.aabb_hi.cpu().numpy(),
        )

    @classmethod
    def load(cls, path: str, device=None) -> "OccupancyGrid":
        with np.load(path) as z:
            return cls(*(torch.from_numpy(np.array(z[k])).to(device) for k in ("grid", "lo", "hi")))


def _linspace(start: float, stop: float, n: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, n)`'s formula in f32: start·(1 − s) +
    stop·s over the steps s of `linspace01`, the last value `stop` itself
    (XLA's CPU code reassociates and contracts it, an ulp apart at some
    values)."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    s = linspace01(n, device=device)[:-1]
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([a * (1.0 - s) + b * s, b[None]])


def ray_aabb(poses, intrinsics, height: int, width: int, near: float, far: float,
             margin: float = 0.05, grid: int = 8):
    """World AABB of the sampling region: min/max over a coarse pixel grid
    of every pose's rays at t = near and t = far, padded by `margin` of its
    extent. Returns (lo, hi) as f32 numpy (3,)."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    ii = np.linspace(0, height - 1, grid).astype(np.int64)
    jj = np.linspace(0, width - 1, grid).astype(np.int64)
    for pose in np.asarray(poses):
        ro, rd = get_ray_bundle(height, width, np.asarray(intrinsics, np.float32),
                                torch.as_tensor(np.asarray(pose[:3, :4], np.float32)))
        ro = ro.numpy()[ii[:, None], jj[None, :]].reshape(-1, 3)
        rd = rd.numpy()[ii[:, None], jj[None, :]].reshape(-1, 3)
        for t in (near, far):
            p = ro + t * rd
            lo = np.minimum(lo, p.min(axis=0))
            hi = np.maximum(hi, p.max(axis=0))
    pad = (hi - lo) * margin
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


def _dilate(grid: torch.Tensor, steps: int) -> torch.Tensor:
    """3D morphological dilation (3³ max window, stride 1, padded with
    −inf as JAX's `reduce_window` "SAME"), `steps` times."""
    g = grid.float()[None, None]
    for _ in range(max(steps, 0)):
        g = F.max_pool3d(g, kernel_size=3, stride=1, padding=1)
    return g[0, 0] > 0.5


def default_sigma_threshold(near: float, far: float, num_coarse: int, alpha: float = 1e-2) -> float:
    """σ whose alpha over one coarse sampling step is `alpha`: below it a
    voxel is invisible at the renderer's own resolution."""
    dz = (far - near) / max(num_coarse, 1)
    return float(-np.log1p(-alpha) / max(dz, 1e-8))


def _model_device(model, device):
    if device is not None:
        return torch.device(device)
    p = next(iter(model.parameters()), None) if hasattr(model, "parameters") else None
    return p.device if p is not None else torch.device("cpu")


@torch.no_grad()
def build_occupancy_grid(
    model,
    encode_xyz,
    encode_dir,
    aabb_lo,
    aabb_hi,
    resolution: int = 64,
    expressions: Optional[Sequence[np.ndarray]] = None,
    latent_code: Optional[np.ndarray] = None,
    sigma_threshold: float = 1.0,
    dilate: int = 1,
    chunk: int = 65536,
    dtype=None,
    supersample: int = 1,
    device=None,
) -> OccupancyGrid:
    """Sweep the field over voxel centres; a voxel is occupied if its σ
    clears `sigma_threshold` under ANY of `expressions` (max-pooled), at the
    fixed view direction [0, 0, −1] (every paper-family model computes σ
    before the direction branch). `supersample=s` evaluates an (s·res)³
    grid and marks a voxel if any of its s³ sub-centres clears the
    threshold. Runs on `device` (default: the model's)."""
    dev = _model_device(model, device)
    ss = max(int(supersample), 1)
    res = int(resolution) * ss
    lo = torch.as_tensor(np.asarray(aabb_lo, np.float32), device=dev)
    hi = torch.as_tensor(np.asarray(aabb_hi, np.float32), device=dev)
    centers = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    gx, gy, gz = torch.meshgrid(centers, centers, centers, indexing="ij")
    pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * (hi - lo) + lo

    n = pts.shape[0]
    chunk = int(min(chunk, n))
    exprs = [None] if expressions is None else [
        torch.as_tensor(np.asarray(e, np.float32), device=dev) for e in expressions
    ]
    latent = (torch.as_tensor(np.asarray(latent_code, np.float32), device=dev)
              if latent_code is not None else None)
    dir_feat = None
    if encode_dir is not None:
        fixed = encode_dir(torch.tensor([[0.0, 0.0, -1.0]], device=dev))
        dir_feat = fixed.expand(chunk, fixed.shape[-1])

    sigma = torch.empty(n, dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk):
        p = pts[c0:c0 + chunk]
        pe = encode_xyz(p[:, None, :])  # (chunk "rays", 1 sample, D)
        df = dir_feat[: p.shape[0]] if dir_feat is not None else None
        best = None
        for e in exprs:
            out = model(pe, df, e if model.takes_expression else None,
                        latent if model.takes_latent else None, dtype=dtype)
            s = out[..., 3].reshape(-1).float()
            best = s if best is None else torch.maximum(best, s)
        sigma[c0:c0 + chunk] = best
    occ = sigma.reshape(res, res, res) > float(sigma_threshold)
    if ss > 1:
        r = res // ss
        occ = occ.reshape(r, ss, r, ss, r, ss).any(dim=5).any(dim=3).any(dim=1)
    return OccupancyGrid(_dilate(occ, dilate), lo, hi)


def ray_occupancy_mask(occ: OccupancyGrid, ray_origins, ray_directions, near: float, far: float,
                       n_probes: int = 128) -> torch.Tensor:
    """(n,) bool: does the ray touch any occupied voxel at one of
    `n_probes` equidistant probe points over [near, far]? `fast_eval_setup`
    sizes `n_probes` from the grid so the probes cannot step over a
    (dilated) voxel."""
    res = occ.resolution
    t = _linspace(float(near), float(far), int(n_probes), ray_origins.device)
    pts = ray_origins[:, None, :] + ray_directions[:, None, :] * t[None, :, None]
    u = (pts - occ.aabb_lo) / (occ.aabb_hi - occ.aabb_lo)
    in_box = ((u >= 0.0) & (u < 1.0)).all(dim=-1)
    idx = torch.clamp((u * res).to(torch.int32), 0, res - 1).long()
    hit = occ.grid[idx[..., 0], idx[..., 1], idx[..., 2]]
    return (hit & in_box).any(dim=-1)


def ray_occupancy_mask_splat(occ: OccupancyGrid, pose, intrinsics, height: int,
                             width: int) -> torch.Tensor:
    """(H·W,) bool: the conservative occupancy mask by projection
    splatting. A pixel's ray meets a voxel box iff the pixel lies in the
    box's projection, which for a box in front of the camera lies in the
    pixel bbox of its 8 projected corners; each occupied box's (floor/ceil)
    corner bbox is added to a 2D difference array, and two cumulative sums
    give the mask. Boxes with a corner at or behind the camera plane splat
    the whole frame. Needs `occ.with_boxes()`. Pixel convention of
    `ops/rays.pixel_directions`: col = fx·qx/(−qz) + W·cx,
    row = H·cy − fy·qy/(−qz) for the camera-frame q = Rᵀ(p − t)."""
    dev = occ.boxes_lo.device
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev)
    if intr.ndim == 0:
        half = torch.tensor(0.5, device=dev)
        intr = torch.stack([intr, intr, half, half])
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    rot, t = pose[:3, :3], pose[:3, 3]
    bits = torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                        dtype=torch.float32, device=dev)
    corners = (occ.boxes_lo[:, None, :] * (1.0 - bits)[None]
               + occ.boxes_hi[:, None, :] * bits[None])  # (K, 8, 3)
    q = (corners - t) @ rot
    z = -q[..., 2]
    front = (z > 1e-6).all(dim=1)
    zs = torch.clamp(z, min=1e-6)
    col = intr[0] * q[..., 0] / zs + width * intr[2]
    row = height * intr[3] - intr[1] * q[..., 1] / zs
    c0 = torch.floor(col.amin(dim=1))
    c1 = torch.ceil(col.amax(dim=1))
    r0 = torch.floor(row.amin(dim=1))
    r1 = torch.ceil(row.amax(dim=1))
    zero, full_r, full_c = torch.zeros_like(r0), torch.full_like(r1, height - 1.0), \
        torch.full_like(c1, width - 1.0)
    r0, r1 = torch.where(front, r0, zero), torch.where(front, r1, full_r)
    c0, c1 = torch.where(front, c0, zero), torch.where(front, c1, full_c)

    # rectangle splat via a 2D difference array; off-frame rectangles clip
    # to zero area (their +w/−w land on one index and cancel)
    w = occ.boxes_valid.to(torch.int32)
    r0i = torch.clamp(r0, 0, height).long()
    c0i = torch.clamp(c0, 0, width).long()
    r1i = torch.clamp(r1 + 1.0, 0, height).long()
    c1i = torch.clamp(c1 + 1.0, 0, width).long()
    diff = torch.zeros(height + 1, width + 1, dtype=torch.int32, device=dev)
    diff.index_put_(
        (torch.cat([r0i, r0i, r1i, r1i]), torch.cat([c0i, c1i, c0i, c1i])),
        torch.cat([w, -w, -w, w]), accumulate=True,
    )
    m = torch.cumsum(torch.cumsum(diff, dim=0, dtype=torch.int32), dim=1, dtype=torch.int32)
    return (m[:height, :width] > 0).reshape(height * width)


@torch.no_grad()
def tighten_aabb(model, encode_xyz, encode_dir, aabb_lo, aabb_hi, expressions, latent_code,
                 sigma_threshold: float, dtype=None, prepass_resolution: int = 32,
                 pad_voxels: int = 2, device=None):
    """Shrink the frustum AABB to the field's occupied region by a coarse
    prepass grid, padded by `pad_voxels` prepass voxels; the input box when
    the prepass finds nothing (an untrained field)."""
    occ0 = build_occupancy_grid(
        model, encode_xyz, encode_dir, aabb_lo, aabb_hi, resolution=prepass_resolution,
        expressions=expressions, latent_code=latent_code, sigma_threshold=sigma_threshold,
        dilate=1, dtype=dtype, device=device,
    )
    g = occ0.grid.cpu().numpy()
    lo3 = np.asarray(aabb_lo, np.float32)
    hi3 = np.asarray(aabb_hi, np.float32)
    if not g.any():
        return lo3, hi3
    idx = np.argwhere(g)
    vox = (hi3 - lo3) / float(prepass_resolution)
    tlo = lo3 + (idx.min(0) - pad_voxels) * vox
    thi = lo3 + (idx.max(0) + 1 + pad_voxels) * vox
    return np.maximum(tlo, lo3), np.minimum(thi, hi3)


def conservative_block(occ: OccupancyGrid, intrinsics, far: float, height: int, width: int,
                       dilate: int = 1, max_block: int = 8) -> int:
    """Largest power-of-two pixel block B (dividing H and W, ≤ `max_block`)
    such that probing one ray per B×B block against the `dilate`-dilated
    grid stays conservative: a ray is ≤ far·(B·√2/2)/f world units from its
    block's centre ray at the far plane, which must fit in half the grid's
    dilation margin. 1 when even B = 2 does not."""
    vox = float(np.min(occ.aabb_hi.cpu().numpy() - occ.aabb_lo.cpu().numpy()) / occ.resolution)
    f_min = float(np.min(np.asarray(intrinsics, np.float64)[:2]))
    limit = dilate * vox * f_min / (np.sqrt(2.0) * float(far))
    b = 1
    while b * 2 <= max_block and b * 2 <= limit and height % (b * 2) == 0 and width % (b * 2) == 0:
        b *= 2
    return b


def ray_occupancy_mask_blocked(occ: OccupancyGrid, ray_origins, ray_directions, height: int,
                               width: int, near: float, far: float, n_probes: int,
                               block: int) -> torch.Tensor:
    """(H·W,) bool: `ray_occupancy_mask` of one ray per `block`×`block`
    pixel block (its centre ray), broadcast to the block."""
    c = block // 2
    ro = ray_origins.reshape(height, width, 3)[c::block, c::block]
    rd = ray_directions.reshape(height, width, 3)[c::block, c::block]
    hb, wb = ro.shape[0], ro.shape[1]
    m = ray_occupancy_mask(occ, ro.reshape(-1, 3), rd.reshape(-1, 3), near, far,
                           n_probes).reshape(hb, wb)
    m = m.repeat_interleave(block, dim=0).repeat_interleave(block, dim=1)
    return m.reshape(height * width)


def fast_eval_setup(dataset, render_poses, render_expressions, settings, model_coarse,
                    latent_codes=None, dtype=None, log: bool = False,
                    extra_expressions: Optional[Sequence[np.ndarray]] = None, device=None):
    """The fast-eval setup shared by the server and the eval driver: the
    head-bbox union over the test split with the capacity sized to it and,
    with `settings.occupancy`, the grid built from the trained field with
    the capacity tightened to the measured worst active fraction (JAX
    `fast_eval_setup`, same rules and numbers). Returns (bbox, settings,
    grid or None); the grid lives on `device` (default: the model's)."""
    i_test = np.asarray(dataset.i_test)
    bbs = np.asarray(dataset.bboxes)[i_test]
    bbox = np.array([bbs[:, 0].min(), bbs[:, 1].max(), bbs[:, 2].min(), bbs[:, 3].max()],
                    np.int32)
    H, W = dataset.H, dataset.W
    area = float(bbox[1] - bbox[0] + 1) * float(bbox[3] - bbox[2] + 1) / float(H * W)
    settings = dataclasses.replace(settings, fast_eval_capacity=min(1.0, area * 1.05))
    if log:
        print(f"[fast-eval] bbox union {bbox.tolist()}, active capacity "
              f"{settings.fast_eval_capacity:.2f} of {H * W} rays")

    occ = None
    if settings.occupancy:
        lo, hi = ray_aabb(render_poses, dataset.intrinsics, H, W, settings.near, settings.far)
        sample = list(render_expressions[np.linspace(
            0, max(len(render_expressions) - 1, 0), num=8, dtype=np.int64)])
        if extra_expressions is not None:
            sample += [np.asarray(e) for e in extra_expressions]
        lat0 = None
        if latent_codes is not None:
            lat0 = np.asarray(torch.as_tensor(latent_codes[0]).detach().cpu(), np.float32)
        thr = default_sigma_threshold(settings.near, settings.far, settings.num_coarse)
        if settings.occupancy_mask not in ("splat", "probe"):
            raise ValueError("nerf.validation.occupancy_mask must be 'splat' or "
                             f"'probe', got {settings.occupancy_mask!r}")
        splat = settings.occupancy_mask == "splat"
        if splat:
            # smaller voxels at the same resolution: a tighter silhouette
            lo, hi = tighten_aabb(model_coarse, settings.encode_xyz, settings.encode_dir, lo, hi,
                                  sample, lat0, thr, dtype=dtype, device=device)
        occ = build_occupancy_grid(
            model_coarse, settings.encode_xyz, settings.encode_dir, lo, hi,
            resolution=settings.occupancy_resolution, expressions=sample, latent_code=lat0,
            sigma_threshold=thr, dilate=settings.occupancy_dilate, dtype=dtype,
            # the splat mask is exact per voxel: a 2× supersampled build
            # instead of the probe modes' dilation halo
            supersample=2 if splat else 1, device=device,
        )
        block = settings.occupancy_block
        if splat:
            occ = occ.with_boxes()
            block = 1
        elif block == 0:
            # one probed ray per B×B block, B from the bound of the grid's
            # actual dilation (1 for an undilated grid)
            block = conservative_block(occ, dataset.intrinsics, settings.far, H, W,
                                       dilate=settings.occupancy_dilate)
        if not splat:
            # probes at most half a dilated voxel apart along [near, far]
            vox = float(np.min(occ.aabb_hi.cpu().numpy() - occ.aabb_lo.cpu().numpy())) \
                / occ.resolution
            halo = max(settings.occupancy_dilate, 1) * vox
            needed = int(np.ceil((settings.far - settings.near) / (halo / 2.0))) + 1
            if needed > settings.occupancy_probes:
                if log:
                    print(f"[fast-eval] occupancy_probes {settings.occupancy_probes} -> {needed} "
                          f"(probe spacing bound for {occ.resolution}^3 voxels, "
                          f"dilate={settings.occupancy_dilate})")
                settings = dataclasses.replace(settings, occupancy_probes=needed)
        frac = active_fraction(occ, render_poses, dataset.intrinsics, H, W, settings.near,
                               settings.far, settings.occupancy_probes, block=block)
        # exact for these poses; the margin is headroom for novel poses
        settings = dataclasses.replace(
            settings, occupancy_block=block,
            fast_eval_capacity=min(settings.fast_eval_capacity,
                                   min(1.0, frac * settings.occupancy_margin)),
        )
        if log:
            print(f"[fast-eval] occupancy grid {settings.occupancy_resolution}^3 "
                  f"({occ.occupancy_fraction():.3f} occupied), mask block {block}, active "
                  f"capacity {settings.fast_eval_capacity:.2f}")
    return bbox, settings, occ


@torch.no_grad()
def active_fraction(occ: OccupancyGrid, poses, intrinsics, height: int, width: int, near: float,
                    far: float, n_probes: int = 128, block: int = 1) -> float:
    """Max over `poses` of the fraction of rays the grid keeps, by the mask
    the renderer uses: the splat mask when the grid carries boxes, else
    probing with the render-time `block`."""
    dev = occ.grid.device
    best = 0.0
    for pose in np.asarray(poses):
        pose = torch.as_tensor(np.asarray(pose[:3, :4], np.float32), device=dev)
        if occ.boxes_lo is not None:
            m = ray_occupancy_mask_splat(occ, pose, intrinsics, height, width)
        else:
            ro, rd = get_ray_bundle(height, width, intrinsics, pose)
            ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
            if block > 1:
                m = ray_occupancy_mask_blocked(occ, ro, rd, height, width, near, far, n_probes,
                                               block)
            else:
                m = ray_occupancy_mask(occ, ro, rd, near, far, n_probes)
        best = max(best, float(m.float().mean()))
    return best
