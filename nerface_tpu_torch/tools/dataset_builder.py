"""Dataset builder: face-tracker output → NeRF JSON datasets. A copy of
`nerface_tpu/tools/dataset_builder.py` (numpy and Pillow; scipy where
the Euler sequences use it) that draws from numpy's generator as JAX's
does, so its datasets and `index_map.npy` are the JAX package's.


Equivalent of `real_to_nerf.py` (reference, 1543 LoC). Input layout
(produced by an offline face tracker):

    source/
      images/           per-frame RGB frames (sorted by filename)
      intrinsics.txt    one row [fx_rel, fy_rel, cx_rel, cy_rel]
      rigid.txt         N rows of flattened 4x4 head poses
      expression.txt    N rows of 76-dim blendshape coefficients

Output: `target/{train,val,test}/f_%04d.png`, `transforms_{split}.json`
(camera_angle_x, intrinsics, frames[{file_path, transform_matrix,
expression, bbox}]) and `index_map.npy` — the exact format consumed by
`nerface_tpu_torch.data.flame` (and the reference's `load_flame.py`).

Reproduced semantics (file:line refer to `real_to_nerf.py`):

* intrinsics unpacking incl. the sign/flip quirks (:65-77);
* rigid pose fix: columns 0 and 2 negated, scene scaled so the mean camera
  z is 0.5 (:79-89);
* random train/val partition + `index_map.npy` dataset-order →
  shuffled-train-order map (:107-112,1435-1446,1483);
* head-bbox detection (:204-238) — the reference rasterizes the mean-face
  mesh with pyrender/EGL and thresholds white; this image has no GL stack,
  so `mesh_bbox` projects the mesh *vertices* with the same camera model
  and applies the same enlargement ratios. `find_bbox` (the image
  thresholding variant) is also provided for pre-rendered masks;
* driven reenactment sequences with neutral-relative expression-delta
  transfer (:497-601) — the per-person neutral frame ids the reference
  hardcodes (:580-597) are arguments here;
* Euler-waypoint presentation sequences (:427-494), ellipse/circle camera
  paths (:241-334), original-sequence test export (:1335-1400).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nerface_tpu_torch.tools.rasterizer import load_off_mesh, render_mask_image


# --------------------------------------------------------------------------
# Tracker-output readers
# --------------------------------------------------------------------------

def read_intrinsics(
    path: str,
    im_size: Optional[Tuple[int, int]] = None,
    center_crop_fix_intrinsics: bool = False,
) -> np.ndarray:
    """[fx, fy, cx, cy]. With `im_size=(W, H)` the relative tracker values
    are scaled to pixels with the reference's sign/flip quirks
    (`real_to_nerf.py:65-77`: fx,fy scaled by -W/-H; cy flipped 1-y)."""
    rows = np.atleast_2d(np.genfromtxt(path, dtype=np.float64))
    first = rows[0]
    if im_size is None:
        return first
    w, h = im_size
    fx = first[0] * -w
    fy = first[1] * -h
    cx = first[2] * w
    if center_crop_fix_intrinsics:
        cx = first[2] * w * 0.5625  # 1280 -> 720 1:1 center-crop fix (:73)
    cy = (1 - first[3]) * h
    return np.array([fx, fy, cx, cy])


def read_rigid_poses(path: str, mean_scale: bool = True) -> Tuple[np.ndarray, float]:
    """(N, 4, 4) head poses with the reference's coordinate fix: columns 0
    and 2 negated, translations scaled so mean camera z == 0.5
    (`real_to_nerf.py:79-89`)."""
    rigids = np.genfromtxt(path, dtype=np.float64).reshape(-1, 4, 4)
    rigids[:, :, 0] *= -1
    rigids[:, :, 2] *= -1
    scale = 0.5 / np.mean(rigids[:, 2, -1])
    if mean_scale:
        rigids[:, 0:3, -1] *= scale
    return rigids, float(scale)


def read_expressions(path: str) -> np.ndarray:
    return np.atleast_2d(np.genfromtxt(path, dtype=np.float64))


def read_img_folder(path: str) -> Tuple[List[str], int, Tuple[int, int]]:
    """Sorted image names, count, and (W, H) of the first image
    (`real_to_nerf.py:96-105`)."""
    from PIL import Image

    names = sorted(os.listdir(path))
    if not names:
        raise FileNotFoundError(f"no images in {path}")
    with Image.open(os.path.join(path, names[0])) as im0:
        im_size = im0.size
    return names, len(names), im_size


def train_val_partition(
    N: int, n_train: int, n_val: int, n_test: int,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """Random permutation split (`real_to_nerf.py:107-112`)."""
    perm = (rng or np.random).permutation(N)
    return {
        "train": perm[:n_train],
        "val": perm[n_train:n_train + n_val],
        "test": perm[n_train + n_val:n_train + n_val + n_test],
    }


# --------------------------------------------------------------------------
# Camera path helpers
# --------------------------------------------------------------------------

def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def look_at(
    cam_pos_world: np.ndarray,
    to_pos_world: np.ndarray,
    up: np.ndarray = np.array([0.0, 1.0, 0.0]),
) -> np.ndarray:
    """Right-handed look-at c2w matrix (`real_to_nerf.py:32-47`)."""
    cam_pos_world = np.asarray(cam_pos_world, np.float64)
    forward = normalize(cam_pos_world - np.asarray(to_pos_world, np.float64))
    right = normalize(np.cross(normalize(up), forward))
    up2 = normalize(np.cross(forward, right))
    c2w = np.zeros((4, 4))
    c2w[0, :-1] = right
    c2w[1, :-1] = up2
    c2w[2, :-1] = forward
    c2w[3, :-1] = cam_pos_world
    c2w[3, 3] = 1.0
    return c2w.T


def look_at_like_other_cam(
    cam_pos_world: np.ndarray,
    orig_cam_matrix: np.ndarray,
    up: np.ndarray = np.array([0.0, 1.0, 0.0]),
) -> np.ndarray:
    """Move a camera to a new position while keeping its relative offset
    from the pure look-at orientation (`real_to_nerf.py:50-63`)."""
    gt_rot = orig_cam_matrix[:3, :3]
    orig_rot = look_at(orig_cam_matrix[:3, -1], np.zeros(3), up)[:3, :3]
    new_rot = look_at(cam_pos_world, np.zeros(3), up)[:3, :3]
    rot = gt_rot @ orig_rot.T @ new_rot
    pose = np.eye(4)
    pose[:3, :3] = rot
    pose[:3, -1] = cam_pos_world
    return pose


def ellipse(a: float, b: float, N: int, half: bool = False):
    """Elliptical xy path (`real_to_nerf.py:275-283`)."""
    x0 = np.linspace(-a, a, int(N // 2))
    y0 = np.sqrt(np.maximum(b**2 - (b**2) / (a**2) * np.power(x0, 2), 0.0))
    if half:
        return x0, y0
    return np.concatenate((x0, np.linspace(a, -a, int(N // 2)))), np.concatenate((y0, -y0))


def circle(r_squared: float, N: int, half: bool = False):
    """Near-circular xyz path on a sphere (`real_to_nerf.py:285-298`)."""
    r = np.sqrt(r_squared)
    x0 = np.linspace(-0.4 * r, 0.4 * r, int(N // 2))
    y0 = np.linspace(-0.05 * r, 0.05 * r, int(N // 2))
    z0 = np.sqrt(np.maximum(r_squared - x0**2 - y0**2, 0.0))
    if half:
        return x0, y0, z0
    return (
        np.concatenate((x0, -x0)),
        np.concatenate((y0, -y0)),
        np.concatenate((z0, z0)),
    )


def custom_sequence(neutral_pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-sweep camera path around the neutral position with zero
    expressions (`real_to_nerf.py:241-270`)."""
    xn, yn, zn = neutral_pose[0, -1], neutral_pose[1, -1], neutral_pose[2, -1]
    pts = np.tile(np.array([xn, yn, zn]), (120, 1))
    pts[0:60, 0] = np.linspace(-0.6, 0.6, 60)
    pts[60:120, 1] = np.linspace(-0.3, 0.5, 60)
    rigids = np.stack([look_at(p, np.zeros(3)) for p in pts])
    return np.zeros((120, 76)), rigids


def custom_sequence_circle(
    neutral_pose: np.ndarray, xmin: float, xmax: float, ymin: float, ymax: float,
    n_pts: int = 120,
) -> Tuple[None, np.ndarray]:
    """Elliptical camera orbit at fixed depth (`real_to_nerf.py:301-334`)."""
    xn, yn, zn = neutral_pose[0, -1], neutral_pose[1, -1], neutral_pose[2, -1]
    x, y = ellipse((xmax - xmin) / 2, (ymax - ymin) / 2, n_pts)
    pts = np.stack([x + xn, y + yn, np.full_like(x, zn - 0.1)], axis=-1)
    rigids = np.stack([look_at(p, np.zeros(3)) for p in pts])
    return None, rigids


# --------------------------------------------------------------------------
# Euler-angle sequence machinery
# --------------------------------------------------------------------------

def poses_to_head_euler(poses: np.ndarray) -> np.ndarray:
    """Per-frame head rotation as xyz Euler degrees of the *inverse* pose —
    moving-camera-fixed-head → fixed-camera-moving-head
    (`real_to_nerf.py:433-440`)."""
    from scipy.spatial.transform import Rotation as R

    angles = np.zeros((len(poses), 3))
    for i, pose in enumerate(poses):
        angles[i] = R.from_matrix(np.linalg.inv(pose)[:3, :3]).as_euler(
            "xyz", degrees=True
        )
    return angles


def euler_to_camera_poses(angles: np.ndarray, base_pose: np.ndarray) -> np.ndarray:
    """Head Euler angles back to moving-camera poses: camera = Rᵀ·base
    (`real_to_nerf.py:479-493`: "camera pose is P·R_inv = P·R_t", applied
    as rot_invᵀ @ base)."""
    from scipy.spatial.transform import Rotation as R

    rotations = R.from_euler("xyz", angles, degrees=True).as_matrix()
    out = np.zeros((len(angles), 4, 4))
    rot_inv = np.eye(4)
    for i in range(len(angles)):
        rot_inv[:3, :3] = rotations[i].T
        out[i] = rot_inv @ base_pose
    return out


def euler_waypoint_sequence(
    rigid_poses: np.ndarray,
    expressions: np.ndarray,
    interp_frames: int = 60,
    hold_frames: int = 100,
) -> Tuple[np.ndarray, np.ndarray]:
    """Presentation sequence: interpolate head angles through half-extreme
    waypoints with holds (`custom_seq_presentation_v2`,
    `real_to_nerf.py:427-494`)."""
    angles = poses_to_head_euler(rigid_poses)
    x_min, x_max = angles[:, 0].min(), angles[:, 0].max()
    y_min, y_max = angles[:, 1].min(), angles[:, 1].max()
    x = np.hstack((angles[0, 0], x_min * 0.5, x_max * 0.5, x_max * 0.5))
    y = np.hstack((angles[0, 1], y_min * 0.5, y_max * 0.5, y_min * 0.5))
    z = np.hstack((angles[0, 2], 0.0, 0.0, 0.0))
    segments = []
    for i in range(3):
        start = np.array([x[i], y[i], z[i]])
        end = np.array([x[i + 1], y[i + 1], z[i + 1]])
        segments.append(np.linspace(start, end, interp_frames))
        segments.append(np.repeat(end[None, :], hold_frames, axis=0))
    out_angles = np.concatenate(segments, axis=0)
    out_poses = euler_to_camera_poses(out_angles, rigid_poses[0])
    n = len(out_angles)
    return expressions[:n], out_poses


def driven_sequence(
    rigid_poses_driving: np.ndarray,
    rigid_poses_target: np.ndarray,
    expressions_driving: np.ndarray,
    expressions_target: np.ndarray,
    neutral_driving_idx: Optional[int] = None,
    neutral_target_idx: Optional[int] = None,
    transfer_deltas: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-actor reenactment: the driving actor's head rotations applied
    around the target's most-frontal pose, with neutral-relative expression
    deltas transferred onto the target's neutral face
    (`custom_seq_driving`, `real_to_nerf.py:497-601`).

    The reference hardcodes per-person neutral frame indices (:580-597);
    here they default to the frame with the smallest expression norm.
    """
    angles_driving = poses_to_head_euler(rigid_poses_driving)

    # Most frontal target pose — up/down down-weighted 0.5 (:523-529).
    angles_target = poses_to_head_euler(rigid_poses_target)
    angles_target[:, 0] *= 0.5
    index_frontal = int(np.argmin(np.linalg.norm(angles_target, axis=-1)))

    out_poses = euler_to_camera_poses(
        angles_driving, rigid_poses_target[index_frontal]
    )
    n_out = len(out_poses)

    if transfer_deltas:
        if neutral_driving_idx is None:
            neutral_driving_idx = int(
                np.argmin(np.linalg.norm(expressions_driving, axis=-1))
            )
        if neutral_target_idx is None:
            neutral_target_idx = int(
                np.argmin(np.linalg.norm(expressions_target, axis=-1))
            )
        neutral_driving = expressions_driving[neutral_driving_idx]
        neutral_target = expressions_target[neutral_target_idx]
        delta = expressions_driving[-n_out:] - neutral_driving[None, :]
        expressions_out = neutral_target[None, :] + delta
    else:
        expressions_out = expressions_driving[-n_out:]
    return expressions_out, out_poses


# --------------------------------------------------------------------------
# Expression-waypoint sequence family (`real_to_nerf.py:604-1138`)
#
# The reference hardcodes per-person frame indices and blendshape-component
# edits (Norman/Dave values); those are arguments here, defaulting to the
# reference's live values so oracle tests can pin bit-level agreement.
# --------------------------------------------------------------------------

def interpolate_waypoints(waypoints, steps: int = 15) -> np.ndarray:
    """Piecewise-linear path through waypoints, `steps` frames per leg
    (`real_to_nerf.py:683-686`: consecutive np.linspace legs, so each
    waypoint appears twice at interior leg boundaries)."""
    w = [np.asarray(p, np.float64) for p in waypoints]
    return np.concatenate(
        [np.linspace(w[i], w[i + 1], steps) for i in range(len(w) - 1)],
        axis=0,
    )


def _mouth_waypoints(
    expressions: np.ndarray, seq_start: int, neutral_offset: int
) -> List[np.ndarray]:
    """The mouth-play expression waypoints shared by both open-mouth
    variants (`real_to_nerf.py:789-819` == `:939-968`): component edits on
    a neutral frame — open mouth [68]=0.4, closed [68]=-0.5, smile
    [14]=0.4 & [68]=0.4 — visited as neutral → open → closed → neutral →
    smile → closed."""
    neutral = np.array(expressions[seq_start + neutral_offset], np.float64)
    open_mouth = neutral.copy()
    open_mouth[68] = 0.4
    closed = neutral.copy()
    closed[68] = -0.5
    smile = neutral.copy()
    smile[14] = 0.4
    smile[68] = 0.4
    return [neutral, open_mouth, closed, neutral, smile, closed]


def waypoint_seq_xyz(
    rigid_poses: np.ndarray,
    expressions: np.ndarray,
    seq_start: int = 5509,
    neutral_offset: int = 979,
    smile_offset: int = 460,
    smile_mix_idx: int = 5450,
    steps: int = 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expression play at the first source pose (`custom_seq_xyz`,
    `real_to_nerf.py:604-758`).

    Waypoints: a lowered-jaw neutral ([68] -= 0.3), a smile blended 20/80
    from two source frames, and an open-mouth edit ([68]=0.5, [12]=0.4),
    visited n→s→o→s→n→o→s→n with 15-frame legs.  The reference computes a
    head-angle sweep too but its final line tiles the first (identity-
    rotation) pose over every frame (:757) — the emitted sequence is
    expression play at a fixed pose, which is what this returns.
    """
    neutral = np.array(expressions[seq_start + neutral_offset], np.float64)
    neutral[68] -= 0.3
    smile = (
        0.2 * expressions[seq_start + smile_offset]
        + 0.8 * expressions[smile_mix_idx]
    )
    open_mouth = neutral.copy()
    open_mouth[68] = 0.5
    open_mouth[12] = 0.4
    expr_out = interpolate_waypoints(
        [neutral, smile, open_mouth, smile, neutral, open_mouth, smile,
         neutral],
        steps,
    )
    out_poses = np.tile(rigid_poses[0], (len(expr_out), 1, 1))
    return expr_out, out_poses


def waypoint_seq_open_mouth(
    rigid_poses: np.ndarray,
    expressions: np.ndarray,
    seq_start: int = 5506,
    neutral_offset: int = 987,
    steps: int = 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mouth play at the first source pose (`custom_seq_open_mouth`,
    `real_to_nerf.py:761-898`; its angle legs collapse to the identity
    start angle — linspace(num=1) — and the poses are tiled from the
    first, :835,887)."""
    expr_out = interpolate_waypoints(
        _mouth_waypoints(expressions, seq_start, neutral_offset), steps
    )
    out_poses = np.tile(rigid_poses[0], (len(expr_out), 1, 1))
    return expr_out, out_poses


def waypoint_seq_open_mouth_xyz(
    rigid_poses: np.ndarray,
    expressions: np.ndarray,
    seq_start: int = 5506,
    neutral_offset: int = 987,
    base_pose_idx: Optional[int] = None,
    steps: int = 15,
) -> Tuple[np.ndarray, np.ndarray]:
    """Head-rotation sweep + mouth play (`custom_seq_open_mouth_xyz`,
    `real_to_nerf.py:901-1052`) — the branch the reference's live
    `generate_custom_test_sequence` actually calls (:1255).

    Head angles run 8 waypoints (±40% of the observed x/y extremes,
    :928-934) with 15-frame legs around the base pose (default: the
    neutral frame's own pose, :1023).  Reference quirk, reproduced
    faithfully: `expressions_out` prepends a frozen copy of its first row
    for every pose (:1040), so it has n_poses + n_expr rows while
    out_poses has n_poses — and since the JSON writer iterates over POSES
    (:1258-1265), the written sequence is the head sweep at the frozen
    first expression; the mouth-play tail is never emitted."""
    angles = poses_to_head_euler(rigid_poses)
    x_min, x_max = angles[:, 0].min(), angles[:, 0].max()
    y_min, y_max = angles[:, 1].min(), angles[:, 1].max()
    x = [0.0, x_max * 0.4, x_min * 0.4, 0.0, 0.0, 0.0, 0.0, 0.0]
    y = [0.0, 0.0, 0.0, 0.0, y_max * 0.4, 0.0, y_min * 0.4, 0.0]
    z = [0.0] * 8
    out_angles = interpolate_waypoints(np.stack([x, y, z], axis=-1), steps)
    if base_pose_idx is None:
        base_pose_idx = seq_start + neutral_offset
    out_poses = euler_to_camera_poses(out_angles, rigid_poses[base_pose_idx])
    expr_play = interpolate_waypoints(
        _mouth_waypoints(expressions, seq_start, neutral_offset), steps
    )
    expr_out = np.concatenate(
        [np.tile(expr_play[0], (len(out_poses), 1)), expr_play], axis=0
    )
    return expr_out, out_poses


def teaser_sequence(
    rigid_poses: np.ndarray,
    expressions: np.ndarray,
    expression_idxs: Sequence[int] = (
        979, 979, 979, 5680, 5680, 5450, 5450, 5450, 5680, 5450
    ),
    pose_idxs: Sequence[int] = (
        6308, 5450, 6338, 5644, 6129, 6308, 5450, 6338, 5644, 6129
    ),
) -> Tuple[np.ndarray, np.ndarray]:
    """Hand-picked (expression, pose) frame pairs for the paper teaser
    (`custom_seq_teaser`, `real_to_nerf.py:1055-1138`); index defaults are
    the reference's Norman values (:1116-1121), expressions truncated to
    the pose count (:1122,1138).  The reference pops four pyrender debug
    windows here (:1132-1135); use `write_debug_overlays` /
    `tools/rasterizer.py` for the GL-free equivalent."""
    poses = np.asarray(rigid_poses, np.float64)[list(pose_idxs)]
    expr = np.asarray(expressions, np.float64)[list(expression_idxs)]
    return expr[: len(poses)], poses


# --------------------------------------------------------------------------
# Head bbox
# --------------------------------------------------------------------------

BBOX_RATIO = 0.3  # enlargement, `real_to_nerf.py:221-226`


def _enlarge_and_normalize(
    h_min, h_max, w_min, w_max, H: int, W: int
) -> np.ndarray:
    h_span, w_span = h_max - h_min, w_max - w_min
    h_min -= BBOX_RATIO * 0.9 * h_span
    h_max += BBOX_RATIO * 0.5 * h_span
    w_min -= BBOX_RATIO * 0.5 * w_span
    w_max += BBOX_RATIO * 0.5 * w_span
    h_min = int(np.clip(h_min, 0, H - 1))
    h_max = int(np.clip(h_max, 0, H - 1))
    w_min = int(np.clip(w_min, 0, W - 1))
    w_max = int(np.clip(w_max, 0, W - 1))
    return np.array([h_min / H, h_max / H, w_min / W, w_max / W])


def find_bbox(im: np.ndarray) -> np.ndarray:
    """Head bbox from a rendered mask image: non-white pixels, enlarged and
    normalized (`real_to_nerf.py:204-238`)."""
    H, W = im.shape[:2]
    where = np.where(im[:, :, 0] < 255)
    return _enlarge_and_normalize(
        where[0].min(), where[0].max(), where[1].min(), where[1].max(), H, W
    )


def load_off(path: str) -> np.ndarray:
    """Vertices of an OFF mesh (the reference's `average.off` mean face)."""
    return load_off_mesh(path)[0]


def mesh_bbox(
    vertices: np.ndarray,
    pose: np.ndarray,
    intrinsics: np.ndarray,
    scale: float = 1.0,
    H: int = 512,
    W: int = 512,
    mesh_unit_scale: float = 1e-6,
) -> np.ndarray:
    """Head bbox by projecting the mean-face mesh vertices.

    The reference rasterizes the mesh offscreen (pyrender EGL at 512²,
    `render_debug_camera_matrix` :125-197) and thresholds; projecting the
    vertices with the identical camera model (OpenGL convention: camera
    looks down -z, y up) yields the same extremes without a GL stack.
    Mesh units: `average.off` is in micrometers — scaled by 1e-6 then the
    scene scale (:135-137).
    """
    v = vertices * (mesh_unit_scale * scale)
    w2c = np.linalg.inv(pose)
    v_cam = v @ w2c[:3, :3].T + w2c[:3, 3]
    z = v_cam[:, 2]
    valid = z < -1e-9  # in front of an OpenGL camera
    if not valid.any():
        return np.array([0.0, 1.0, 0.0, 1.0])
    fx, fy, cx, cy = intrinsics[:4]
    u = fx * v_cam[valid, 0] / -z[valid] + cx
    vv = -fy * v_cam[valid, 1] / -z[valid] + cy
    # The reference's extremes come from a RASTERIZED mask, which the
    # viewport inherently clips — so clip the projected extremes to the
    # image BEFORE the enlargement ratios are applied (`find_bbox` sees
    # only on-screen pixels). Perspective maps triangles to triangles, so
    # inside the viewport vertex extremes == mask extremes up to pixel
    # discretization (pinned by tests/test_rasterizer.py).
    h_min = np.clip(vv.min(), 0, H - 1)
    h_max = np.clip(vv.max(), 0, H - 1)
    w_min = np.clip(u.min(), 0, W - 1)
    w_max = np.clip(u.max(), 0, W - 1)
    return _enlarge_and_normalize(h_min, h_max, w_min, w_max, H, W)


# --------------------------------------------------------------------------
# Build entry points
# --------------------------------------------------------------------------

@dataclass
class BuilderConfig:
    source: str
    target: str
    driving: Optional[str] = None
    less_data: float = 0.0         # LESS_DATA (:1418-1428)
    reserve_test: int = 1000       # DVP_PARTITION drops the last N (:1411-1415)
    n_val: int = 5
    n_test: int = 1
    mesh_path: Optional[str] = None  # average.off for bbox detection
    seed: Optional[int] = None
    neutral_driving_idx: Optional[int] = None
    neutral_target_idx: Optional[int] = None


def _create_subfolders(target: str) -> None:
    for sub in ("train", "val", "test", "bg", "debug_vis"):
        os.makedirs(os.path.join(target, sub), exist_ok=True)


def _load_source(cfg: BuilderConfig):
    names, N, im_size = read_img_folder(os.path.join(cfg.source, "images"))
    intrinsics = read_intrinsics(
        os.path.join(cfg.source, "intrinsics.txt"), im_size
    )
    expressions = read_expressions(os.path.join(cfg.source, "expression.txt"))
    rigid_poses, scale = read_rigid_poses(os.path.join(cfg.source, "rigid.txt"))
    return names, N, im_size, intrinsics, expressions, rigid_poses, scale


def _dump_transforms(
    target: str, mode: str, frames: List[dict],
    intrinsics: np.ndarray, im_size: Tuple[int, int],
) -> None:
    """Write transforms_<mode>.json with the reference's relative-center
    convention: cx /= H, cy /= W — equal for square frames
    (`real_to_nerf.py:1474-1482`); fx, fy stay in pixels."""
    out = np.copy(np.asarray(intrinsics, np.float64))
    out[3] /= im_size[0]
    out[2] /= im_size[1]
    camera_angle = 2 * np.arctan(im_size[0] / (2 * intrinsics[0]))
    with open(os.path.join(target, f"transforms_{mode}.json"), "w") as fp:
        json.dump(
            {
                "camera_angle_x": float(camera_angle),
                "frames": frames,
                "intrinsics": out.tolist(),
            },
            fp,
            indent=4,
        )


def _copy_frame(src_path: str, dst_path: str) -> None:
    from PIL import Image

    with Image.open(src_path) as im:
        im.save(dst_path, "png")


def write_debug_overlays(
    cfg: BuilderConfig,
    frame_range=None,
    log: bool = True,
) -> int:
    """Debug camera-overlay frames (`real_to_nerf.py:1520-1543`): the mean
    face rasterized under each rigid pose (tools/rasterizer.py — no GL
    stack) and blended onto the source frame, 0.8·render + 0.2·image where
    the render is non-white, saved to target/debug_vis/r_%04d.png. A quick
    visual check that the tracked poses and the scene scale line up.
    Returns the number of frames written."""
    from PIL import Image

    if cfg.mesh_path is None:
        raise ValueError("debug overlays need mesh_path (average.off)")
    names, N, im_size, intrinsics, _, rigid_poses, scale = _load_source(cfg)
    verts, faces = load_off_mesh(cfg.mesh_path)
    out_dir = os.path.join(cfg.target, "debug_vis")
    os.makedirs(out_dir, exist_ok=True)
    if frame_range is None:
        frame_range = range(min(N, 100))
    written = 0
    for i in frame_range:
        if i >= N:
            break
        color = render_mask_image(
            verts, faces, rigid_poses[i], intrinsics,
            H=im_size[0], W=im_size[1], scale=scale,
        )
        with Image.open(
            os.path.join(cfg.source, "images", names[i])
        ) as im:
            im_real = np.asarray(im.convert("RGB"))
        overlay = np.copy(im_real)
        idx = np.where(color < 255)
        overlay[idx] = (0.8 * color[idx] + 0.2 * overlay[idx]).astype(np.uint8)
        Image.fromarray(overlay).save(
            os.path.join(out_dir, "r_%04d.png" % i)
        )
        written += 1
        if log and written % 50 == 0:
            print(f"[debug_vis] {written} overlays")
    return written


def build_dataset(cfg: BuilderConfig, log: bool = True) -> Dict[str, np.ndarray]:
    """Train/val JSON build (`main`, `real_to_nerf.py:1403-1484`).

    Returns the index splits. Head bboxes come from `mesh_bbox` when
    `cfg.mesh_path` is given, else default to the full frame.
    """
    names, N, im_size, intrinsics, expressions, rigid_poses, scale = _load_source(cfg)

    if cfg.reserve_test > 0 and N > cfg.reserve_test:
        N -= cfg.reserve_test
        names, expressions, rigid_poses = names[:N], expressions[:N], rigid_poses[:N]
    if cfg.less_data > 0:
        n_trim = int(cfg.less_data * N)
        names, expressions, rigid_poses = (
            names[:n_trim], expressions[:n_trim], rigid_poses[:n_trim]
        )
        N = n_trim

    _create_subfolders(cfg.target)
    rng = np.random.RandomState(cfg.seed) if cfg.seed is not None else None
    indices = train_val_partition(N, N - cfg.n_val - cfg.n_test, cfg.n_val,
                                  cfg.n_test, rng=rng)

    mesh_vertices = load_off(cfg.mesh_path) if cfg.mesh_path else None

    index_map = -np.ones((N, 2))
    index_map[:, 0] = np.arange(N)

    for mode in ("train", "val"):  # reference skips 'test' in main (:1438-1440)
        idxs = indices[mode]
        frames: List[dict] = []
        if log:
            print(f"Processing {len(idxs)} {mode} data...")
        for i, idx in enumerate(idxs):
            if mode == "train":
                index_map[idx, 1] = i
            bbox = np.array([0.0, 1.0, 0.0, 1.0])
            if mesh_vertices is not None:
                bbox = mesh_bbox(mesh_vertices, rigid_poses[idx], intrinsics, scale)
            _copy_frame(
                os.path.join(cfg.source, "images", names[idx]),
                os.path.join(cfg.target, mode, f"f_{i:04d}.png"),
            )
            frames.append(
                {
                    "file_path": f"./{mode}/f_{i:04d}",
                    "bbox": bbox.tolist(),
                    "transform_matrix": rigid_poses[idx].tolist(),
                    "expression": expressions[idx].tolist(),
                }
            )
        _dump_transforms(cfg.target, mode, frames, intrinsics, im_size)
        np.save(os.path.join(cfg.target, "index_map.npy"), index_map)
    return indices


def _write_test_sequence(
    cfg: BuilderConfig,
    out_expressions: np.ndarray,
    out_poses: np.ndarray,
    intrinsics: np.ndarray,
    im_size: Tuple[int, int],
    names: Optional[Sequence[str]] = None,
    n_max: Optional[int] = None,
    log: bool = True,
) -> None:
    _create_subfolders(cfg.target)
    N = len(out_poses) if n_max is None else min(len(out_poses), n_max)
    frames = []
    if log:
        print(f"Processing {N} test data...")
    for i in range(N):
        if names is not None and i < len(names):
            _copy_frame(
                os.path.join(cfg.source, "images", names[i]),
                os.path.join(cfg.target, "test", f"f_{i:04d}.png"),
            )
        frames.append(
            {
                "file_path": f"./test/f_{i:04d}",
                "bbox": [0.0, 1.0, 0.0, 1.0],  # test seqs skip bbox (:1196)
                "transform_matrix": out_poses[i].tolist(),
                "expression": out_expressions[i].tolist(),
            }
        )
    _dump_transforms(cfg.target, "test", frames, intrinsics, im_size)


def generate_original_test_sequence(
    cfg: BuilderConfig, n_max: Optional[int] = None, log: bool = True
) -> None:
    """Export the source's own frames as the test split
    (`real_to_nerf.py:1335-1400`)."""
    names, N, im_size, intrinsics, expressions, rigid_poses, _ = _load_source(cfg)
    if cfg.reserve_test > 0 and N > cfg.reserve_test:
        # original test = the reserved tail (:1344-1348 with DVP_PARTITION)
        names = names[-cfg.reserve_test:]
        expressions = expressions[-cfg.reserve_test:]
        rigid_poses = rigid_poses[-cfg.reserve_test:]
    _write_test_sequence(
        cfg, expressions, rigid_poses, intrinsics, im_size,
        names=names, n_max=n_max, log=log,
    )


#: custom test-sequence generators selectable by name
#: (`generate_custom_test_sequence`'s commented-out branch menu,
#: `real_to_nerf.py:1249-1255`; "open_mouth_xyz" is the live branch :1255,
#: "presentation" the `custom_seq_presentation_v2` variant :427-494).
CUSTOM_SEQUENCES = {
    "presentation": euler_waypoint_sequence,
    "xyz": waypoint_seq_xyz,
    "open_mouth": waypoint_seq_open_mouth,
    "open_mouth_xyz": waypoint_seq_open_mouth_xyz,
    "teaser": teaser_sequence,
}


def generate_custom_test_sequence(
    cfg: BuilderConfig,
    n_max: Optional[int] = None,
    log: bool = True,
    sequence: str = "presentation",
    **seq_kwargs,
) -> None:
    """A custom camera/expression path as the test split
    (`real_to_nerf.py:1239-1333`).  `sequence` picks the generator
    (CUSTOM_SEQUENCES); extra kwargs (seq_start, neutral_offset, ...)
    reach it.  As in the reference, the frame count is the POSE count —
    open_mouth_xyz's surplus expression rows are never written (:1258).
    """
    names, N, im_size, intrinsics, expressions, rigid_poses, _ = _load_source(cfg)
    out_expr, out_poses = CUSTOM_SEQUENCES[sequence](
        rigid_poses, expressions, **seq_kwargs
    )
    _write_test_sequence(
        cfg, out_expr, out_poses, intrinsics, im_size,
        names=names, n_max=n_max, log=log,
    )


def generate_driven_test_sequence(
    cfg: BuilderConfig, n_max: Optional[int] = None, log: bool = True
) -> None:
    """Cross-actor reenactment test split (`real_to_nerf.py:1139-1235`)."""
    if not cfg.driving:
        raise ValueError("driven sequence requires cfg.driving")
    names, N, im_size, intrinsics, expressions_target, rigid_target, _ = _load_source(cfg)
    expressions_driving = read_expressions(
        os.path.join(cfg.driving, "expression.txt")
    )
    rigid_driving, _ = read_rigid_poses(os.path.join(cfg.driving, "rigid.txt"))
    out_expr, out_poses = driven_sequence(
        rigid_driving, rigid_target, expressions_driving, expressions_target,
        neutral_driving_idx=cfg.neutral_driving_idx,
        neutral_target_idx=cfg.neutral_target_idx,
    )
    _write_test_sequence(
        cfg, out_expr, out_poses, intrinsics, im_size,
        names=names, n_max=n_max, log=log,
    )
