"""Tiny NeRF — the minimal single-file bring-up target, in PyTorch.

Port of `nerface_tpu/examples/tiny_nerf.py` (the reference's
`tiny_nerf.py:12-350`): ray generation → uniformly spaced depth samples
(jittered) → positional encoding → a 3-layer MLP → alpha compositing →
MSE, overfit on a small multi-view dataset with Adam. No hierarchical
sampling, no conditioning, no hand kernel: plain PyTorch ops.

Data: `--data path/to/tiny_nerf_data.npz` (images, poses, focal), or with
no argument a synthetic multi-view blob dataset made on the fly, so the
example runs offline.

    python -m nerface_tpu_torch.examples.tiny_nerf [--data FILE] [--iters N]
    python -m nerface_tpu_torch.examples.tiny_nerf --device cpu --iters 60
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from nerface_tpu_torch.models.nerf_models import default_init
from nerface_tpu_torch.ops.encoding import positional_encoding
from nerface_tpu_torch.ops.math import cumprod_exclusive
from nerface_tpu_torch.ops.rays import get_ray_bundle


def compute_query_points_from_rays(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    near_thresh: float,
    far_thresh: float,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
):
    """Uniform depths, jittered by U(0, 1)·(far − near)/num_samples when
    `u` (the U(0, 1) draws, shaped (..., num_samples)) is given or drawn
    from `generator` (`tiny_nerf.py:12-65`: the noise is not per stratum
    like the full model's; kept as it is). Returns (points, depths)."""
    dev = ray_origins.device
    depth_values = torch.linspace(near_thresh, far_thresh, num_samples, device=dev)
    if u is None and generator is not None:
        u = torch.rand(ray_origins.shape[:-1] + (num_samples,), generator=generator,
                       device=generator.device).to(dev)
    if u is not None:
        depth_values = depth_values + u * ((far_thresh - near_thresh) / num_samples)
    query_points = (
        ray_origins[..., None, :] + ray_directions[..., None, :] * depth_values[..., :, None]
    )
    return query_points, depth_values


def render_volume_density(radiance_field: torch.Tensor, depth_values: torch.Tensor):
    """Alpha compositing with relu σ and sigmoid rgb (`tiny_nerf.py:68-107`):
    (rgb_map, depth_map, acc_map)."""
    sigma_a = torch.relu(radiance_field[..., 3])
    rgb = torch.sigmoid(radiance_field[..., :3])
    one_e_10 = torch.full_like(depth_values[..., :1], 1e10)
    dists = torch.cat([depth_values[..., 1:] - depth_values[..., :-1], one_e_10], dim=-1)
    alpha = 1.0 - torch.exp(-sigma_a * dists)
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * depth_values, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    return rgb_map, depth_map, acc_map


def init_model(generator: Optional[torch.Generator] = None, num_encoding_functions=6,
               filter_size=128, device=None) -> nn.Sequential:
    """The 3-layer MLP (`VeryTinyNerfModel`, `tiny_nerf.py:162-181`), its
    weights drawn like nn.Linear's default init from `generator`."""
    d_in = 3 + 3 * 2 * num_encoding_functions
    model = nn.Sequential(
        nn.Linear(d_in, filter_size), nn.ReLU(),
        nn.Linear(filter_size, filter_size), nn.ReLU(),
        nn.Linear(filter_size, 4),
    )
    default_init(model, generator)
    return model.to(device or "cpu")


def model_apply(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def run_one_iter_of_tinynerf(
    model, height, width, focal, pose, target, near=2.0, far=6.0, num_samples=32, num_fns=6,
    generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
):
    """One iteration: a full-image render and its MSE against `target`
    (`tiny_nerf.py:111-159,290-299`). Returns (loss, rgb);
    `loss.backward()` gives the gradients."""
    dev = next(model.parameters()).device
    intrinsics = torch.tensor([focal, focal, 0.5, 0.5], dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    ro, rd = get_ray_bundle(height, width, intrinsics, pose[:3, :4])
    pts, z = compute_query_points_from_rays(ro, rd, near, far, num_samples, generator, u)
    pe = positional_encoding(pts, num_fns, True, True)
    rgb, _, _ = render_volume_density(model_apply(model, pe), z)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    return torch.mean((rgb - target) ** 2), rgb


def make_synthetic_tiny_data(n=20, H=48, W=48, num_render_samples=32):
    """Offline stand-in for tiny_nerf_data.npz: multi-view renders of a
    soft-blob volume by the synthetic renderer. (images, poses, focal)."""
    from nerface_tpu_torch.data.synthetic import render_blob_frame
    from nerface_tpu_torch.tools.dataset_builder import look_at
    from nerface_tpu_torch.tools.spherical_sampler import sphere_fibonacci_grid_points

    focal = 0.7 * W
    intrinsics = np.array([focal, focal, 0.5, 0.5], np.float32)
    # cameras on a 0.6-radius sphere around the blob (blob radius ~0.08)
    cams = sphere_fibonacci_grid_points(n) * 0.6
    cams[:, 2] = np.abs(cams[:, 2]) + 0.15
    cams *= 0.6 / np.linalg.norm(cams, axis=-1, keepdims=True)
    images, poses = [], []
    bg = np.zeros((H, W, 3), np.float32)
    expr = np.zeros(76, np.float32)
    for cam in cams:
        c2w = look_at(cam.astype(np.float32), np.zeros(3)).astype(np.float32)
        images.append(render_blob_frame(H, W, intrinsics, c2w, expr, bg,
                                        num_samples=num_render_samples, near=0.2, far=1.2))
        poses.append(c2w)
    return np.stack(images), np.stack(poses), np.float32(focal)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", type=str, default=None,
                        help="tiny_nerf_data.npz (default: a synthetic blob dataset)")
    parser.add_argument("--iters", type=int, default=1000)
    parser.add_argument("--display-every", type=int, default=100)
    parser.add_argument("--lr", type=float, default=5e-3)
    parser.add_argument("--near", type=float, default=None)
    parser.add_argument("--far", type=float, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to train on (default cuda).")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not available "
                           "(pass --device cpu to train on the CPU)")
    if args.data:
        data = np.load(args.data)
        images = data["images"][..., :3].astype(np.float32)
        poses = data["poses"].astype(np.float32)
        focal = np.float32(data["focal"])
        near = args.near if args.near is not None else 2.0  # tiny_nerf.py:211-212
        far = args.far if args.far is not None else 6.0
    else:
        print("No --data given; generating a synthetic blob dataset.")
        images, poses, focal = make_synthetic_tiny_data()
        near = args.near if args.near is not None else 0.2
        far = args.far if args.far is not None else 1.2

    H, W = images.shape[1:3]
    testimg = torch.as_tensor(images[-1], device=device)
    testpose = torch.as_tensor(poses[-1], device=device)
    images = torch.as_tensor(images[:-1], device=device)
    poses = torch.as_tensor(poses[:-1], device=device)

    pick = torch.Generator().manual_seed(9458)
    jitter = torch.Generator(device=device).manual_seed(9458)
    model = init_model(torch.Generator().manual_seed(9458), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    losses, psnr = [], None
    t0 = time.perf_counter()
    for i in range(args.iters):
        idx = int(torch.randint(0, len(images), (), generator=pick))
        loss, _ = run_one_iter_of_tinynerf(model, H, W, float(focal), poses[idx], images[idx],
                                           near=near, far=far, generator=jitter)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

        if i % args.display_every == 0 or i == args.iters - 1:
            with torch.no_grad():
                test_loss, _ = run_one_iter_of_tinynerf(
                    model, H, W, float(focal), testpose, testimg, near=near, far=far,
                    generator=jitter)
            psnr = -10.0 * np.log10(float(test_loss))
            print(f"iter {i}: train loss {losses[-1]:.5f}  "
                  f"test PSNR {psnr:.2f} dB  ({time.perf_counter() - t0:.1f}s)")
    return {"model": model, "losses": [float(v) for v in losses], "psnr": psnr,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
