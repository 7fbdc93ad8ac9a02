"""PyTorch port, the host tools, on the CPU: each module against its JAX
package counterpart on the same seeded numpy inputs.

* `tools/rasterizer.py`: depth bit for bit, mask and face id equal, over
  poses that see the mesh, put it behind the camera, put it off screen and
  fill the screen (the big-triangle path); the mask and debug images equal.
* `tools/dataset_builder.py`: every public function, the waypoint
  sequences held against JAX's functions; `build_dataset` and the three
  `generate_*_test_sequence` on one synthetic tracker directory (JSON,
  `index_map.npy` and PNGs equal); `write_debug_overlays`.
* `cli/build_dataset.py` in every mode against JAX's CLI.
* `tools/mesh_dataset.py`, `tools/point_splat.py` and the port's
  `cli/generate_synthetic.py --mesh / --splat` against JAX's.
* `utils/debug_viz.py::dump_rays` on arrays and on tensors.
* The public names the port adds for the JAX package's: `FlameDataset.hwf`
  / `as_tuple`, `encoding_dim`, `get_embedding_function`, `img2mse`,
  `train_from_config_file` and the package's top-level names.

The meshes are made here: an icosphere written as `.off` and as ASCII and
binary `.ply`. Every comparison of the copied numpy code is exact
(`assert_array_equal`, file bytes or decoded PNG pixels); the encoding is
the one exception, at the tolerance `tests/test_torch_ops.py` holds it to.
"""

import ast
import json
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerface_tpu.cli import build_dataset as jax_build_cli
from nerface_tpu.cli import generate_synthetic as jax_gen_cli
from nerface_tpu.tools import dataset_builder as JB
from nerface_tpu.tools import mesh_dataset as JM
from nerface_tpu.tools import point_splat as JP
from nerface_tpu.tools import rasterizer as JR
from nerface_tpu_torch.cli import build_dataset as build_cli
from nerface_tpu_torch.cli import generate_synthetic as gen_cli
from nerface_tpu_torch.tools import dataset_builder as B
from nerface_tpu_torch.tools import mesh_dataset as M
from nerface_tpu_torch.tools import point_splat as P
from nerface_tpu_torch.tools import rasterizer as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- meshes -----------------------------------------------------------------

def _icosphere(subdivisions=1):
    """An icosahedron, each face split into 4 `subdivisions` times, the
    vertices pushed onto the unit sphere."""
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
        [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1])]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid = {}

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                verts.append(0.5 * (verts[a] + verts[b]))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    v = np.stack(verts)
    return v / np.linalg.norm(v, axis=1, keepdims=True), np.asarray(faces, np.int64)


def _write_off(path, verts, faces, quads=False):
    """OFF text; with `quads` two neighbouring triangles also appear as one
    4-gon (the loader fans it back into two)."""
    with open(path, "w") as f:
        f.write("OFF\n# test mesh\n")
        f.write(f"{len(verts)} {len(faces) + int(quads)} 0\n")
        for v in verts:
            f.write("%.17g %.17g %.17g\n" % tuple(v))
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        if quads:
            f.write(f"4 {faces[0][0]} {faces[0][1]} {faces[0][2]} {faces[1][2]}\n")
    return path


def _write_ascii_ply(path, verts, faces):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment test mesh\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\nproperty uchar red\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write("%.9g %.9g %.9g 7\n" % tuple(v))
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    return path


def _write_binary_ply(path, verts, faces):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(verts))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element face %d\n" % len(faces))
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"element extra 2\nproperty short a\nend_header\n")
        for v in verts:
            f.write(struct.pack("<3f", *v))
        for t in faces:
            f.write(struct.pack("<B3i", 3, *t))
        f.write(struct.pack("<2h", 1, 2))
    return path


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    verts, faces = _icosphere(2)
    return {
        "verts": verts, "faces": faces,
        "off": _write_off(str(d / "sphere.off"), verts, faces, quads=True),
        "ascii": _write_ascii_ply(str(d / "sphere_a.ply"), verts, faces),
        "binary": _write_binary_ply(str(d / "sphere_b.ply"), verts, faces),
        # micrometre units, as the reference's mean face: mesh_bbox and the
        # debug overlays scale by 1e-6
        "face_um": _write_off(str(d / "face_um.off"), verts * 0.08e6, faces),
    }


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(a, b):
    """The same files; JSON equal as data, PNGs equal pixel for pixel,
    everything else byte for byte."""
    assert _files(a) == _files(b)
    assert _files(a)
    for rel in _files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)),
                                          err_msg=rel)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


def _equal(a, b):
    """Outputs of the copied numpy code: equal value for value, container for container."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


# -- the rasterizer ----------------------------------------------------------

INTR = np.array([70.0, 70.0, 32.0, 24.0])


def _cam(pos, target=(0.0, 0.0, 0.0)):
    return B.look_at(np.asarray(pos, np.float64), np.asarray(target, np.float64))


RASTER_POSES = {
    "front": _cam([0.3, 0.2, 4.0]),
    "oblique": _cam([2.5, -1.0, 2.0], [0.1, 0.0, 0.0]),
    "fills_screen": _cam([0.0, 0.1, 1.3]),  # big triangles: the one-at-a-time path
    "behind": _cam([0.0, 0.0, 4.0], [0.0, 0.0, 8.0]),  # the camera looks away
    "off_screen": _cam([0.0, 0.0, 4.0], [6.0, 0.0, 0.0]),
    "straddles": _cam([0.0, 0.0, 0.9]),  # vertices behind and in front
}


@pytest.mark.parametrize("name", sorted(RASTER_POSES))
def test_rasterize_mesh_ids_bit_for_bit(meshes, name):
    verts, faces = meshes["verts"], meshes["faces"]
    pose = RASTER_POSES[name]
    kw = dict(H=48, W=64, mesh_unit_scale=1.0)
    got = R.rasterize_mesh_ids(verts, faces, pose, INTR, **kw)
    want = JR.rasterize_mesh_ids(verts, faces, pose, INTR, **kw)
    _equal(got, want)
    depth, mask, fid = got
    assert np.array_equal(depth.view(np.uint32), want[0].view(np.uint32))  # bit for bit
    if name in ("behind", "off_screen"):
        assert not mask.any() and (fid == -1).all() and np.isinf(depth).all()
    else:
        assert mask.sum() > 50 and (fid[mask] >= 0).all()
    if name == "fills_screen":
        assert mask.mean() > 0.5
    _equal(R.rasterize_mesh(verts, faces, pose, INTR, window=4, **kw),
           JR.rasterize_mesh(verts, faces, pose, INTR, window=4, **kw))
    _equal(R.project_vertices(verts, pose, INTR, 2.0, 0.5),
           JR.project_vertices(verts, pose, INTR, 2.0, 0.5))


def test_mesh_loaders_and_images(meshes):
    _equal(R.load_off_mesh(meshes["off"]), JR.load_off_mesh(meshes["off"]))
    verts, faces = R.load_off_mesh(meshes["off"])
    assert len(faces) == len(meshes["faces"]) + 2  # the 4-gon fanned into two
    pose = RASTER_POSES["front"]
    _equal(R.render_mask_image(verts, faces, pose, INTR, 48, 64, scale=1e6),
           JR.render_mask_image(verts, faces, pose, INTR, 48, 64, scale=1e6))
    got = R.render_debug_camera_matrix(pose, INTR, 1.0, meshes["face_um"], 48, 64)
    _equal(got, JR.render_debug_camera_matrix(pose, INTR, 1.0, meshes["face_um"], 48, 64))
    assert (got[..., 0] < 255).any()
    with pytest.raises(ValueError, match="not an OFF file"):
        R.load_off_mesh(meshes["ascii"])


# -- dataset_builder: the functions ------------------------------------------

@pytest.fixture(scope="module")
def seq_inputs():
    """Tracker-scale inputs large enough for the sequences' default frame
    indices (poses up to 6493, expressions up to 6488)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(7)
    n = 6500
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = Rotation.random(n, random_state=rng).as_matrix()
    poses[:, :3, 3] = 0.1 * rng.randn(n, 3)
    return poses, rng.randn(n, 76) * 0.3


SEQUENCE_CASES = {
    "presentation": {},
    "xyz": {},
    "xyz_small": dict(seq_start=3, neutral_offset=5, smile_offset=2, smile_mix_idx=9, steps=4),
    "open_mouth": {},
    "open_mouth_small": dict(seq_start=1, neutral_offset=2, steps=3),
    "open_mouth_xyz": {},
    "open_mouth_xyz_base": dict(seq_start=1, neutral_offset=2, base_pose_idx=7, steps=5),
    "teaser": {},
    "teaser_small": dict(expression_idxs=(4, 2, 9), pose_idxs=(1, 3)),
}


@pytest.mark.parametrize("case", sorted(SEQUENCE_CASES))
def test_sequences_equal_jax(seq_inputs, case):
    """The waypoint / Euler / teaser generators against JAX's own (inputs
    copied per side: the generators may write into them)."""
    poses, expr = seq_inputs
    name = case.split("_small")[0].split("_base")[0]
    got = B.CUSTOM_SEQUENCES[name](poses.copy(), expr.copy(), **SEQUENCE_CASES[case])
    want = JB.CUSTOM_SEQUENCES[name](poses.copy(), expr.copy(), **SEQUENCE_CASES[case])
    _equal(got, want)
    assert len(got[1]) > 1


def test_camera_paths_and_small_functions_equal_jax(seq_inputs):
    poses, expr = seq_inputs
    rng = np.random.RandomState(3)
    for cam, target, up in ((rng.randn(3), rng.randn(3), np.array([0.0, 1.0, 0.0])),
                            (np.array([0.1, 0.2, 0.5]), np.zeros(3), np.array([0.0, 0.0, 1.0]))):
        _equal(B.look_at(cam, target, up), JB.look_at(cam, target, up))
        _equal(B.look_at_like_other_cam(cam, poses[5], up),
               JB.look_at_like_other_cam(cam, poses[5], up))
    v = rng.randn(5)
    _equal(B.normalize(v), JB.normalize(v))
    for half in (False, True):
        _equal(B.ellipse(0.3, 0.2, 11, half), JB.ellipse(0.3, 0.2, 11, half))
        _equal(B.circle(0.25, 12, half), JB.circle(0.25, 12, half))
    _equal(B.custom_sequence(poses[3]), JB.custom_sequence(poses[3]))
    _equal(B.custom_sequence_circle(poses[3], -0.2, 0.3, -0.1, 0.2, n_pts=14),
           JB.custom_sequence_circle(poses[3], -0.2, 0.3, -0.1, 0.2, n_pts=14))
    angles = B.poses_to_head_euler(poses[:40])
    _equal(angles, JB.poses_to_head_euler(poses[:40]))
    _equal(B.euler_to_camera_poses(angles, poses[1]), JB.euler_to_camera_poses(angles, poses[1]))
    _equal(B.euler_waypoint_sequence(poses[:50], expr[:500], 7, 3),
           JB.euler_waypoint_sequence(poses[:50], expr[:500], 7, 3))
    _equal(B.interpolate_waypoints(expr[:4], 6), JB.interpolate_waypoints(expr[:4], 6))
    for kw in ({}, dict(neutral_driving_idx=3, neutral_target_idx=8),
               dict(transfer_deltas=False)):
        _equal(B.driven_sequence(poses[:30], poses[30:70], expr[:30], expr[30:70], **kw),
               JB.driven_sequence(poses[:30], poses[30:70], expr[:30], expr[30:70], **kw))
    for seed in (0, 11):
        _equal(B.train_val_partition(40, 30, 6, 4, rng=np.random.RandomState(seed)),
               JB.train_val_partition(40, 30, 6, 4, rng=np.random.RandomState(seed)))
    np.random.seed(5)
    a = B.train_val_partition(20, 15, 3, 2)
    np.random.seed(5)
    _equal(a, JB.train_val_partition(20, 15, 3, 2))
    assert sorted(B.CUSTOM_SEQUENCES) == sorted(JB.CUSTOM_SEQUENCES)
    assert B.BBOX_RATIO == JB.BBOX_RATIO


def test_bbox_functions_equal_jax(meshes):
    verts = B.load_off(meshes["face_um"])
    _equal(verts, JB.load_off(meshes["face_um"]))
    intr = np.array([600.0, 600.0, 256.0, 256.0])
    for name, pose in RASTER_POSES.items():
        pose = pose.copy()
        pose[:3, 3] *= 0.25  # the face is 0.08 across
        got = B.mesh_bbox(verts, pose, intr, scale=1.0)
        _equal(got, JB.mesh_bbox(verts, pose, intr, scale=1.0))
        if name == "behind":
            _equal(got, np.array([0.0, 1.0, 0.0, 1.0]))
        img = R.render_mask_image(verts, meshes["faces"], pose, intr, scale=1.0)
        if (img[..., 0] < 255).any():
            _equal(B.find_bbox(img), JB.find_bbox(img))
    with pytest.raises(ValueError, match="not an OFF file"):
        B.load_off(meshes["ascii"])


# -- dataset_builder: the datasets, and the CLI ------------------------------

TRACKER_FRAMES = 18
TRACKER_SIZE = (24, 16)  # W, H: not square, so cx / cy normalise differently


@pytest.fixture(scope="module")
def tracker(tmp_path_factory):
    """Two synthetic tracker directories (random frames, raw tracker pose
    conventions, a neutral-most frame), target and driving."""
    root = tmp_path_factory.mktemp("tracker")
    dirs = {}
    for name, seed in (("target", 0), ("driving", 1)):
        path = str(root / name)
        rng = np.random.RandomState(seed)
        os.makedirs(os.path.join(path, "images"))
        W, H = TRACKER_SIZE
        for i in range(TRACKER_FRAMES):
            Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
                os.path.join(path, "images", f"{i:05d}.png"))
        np.savetxt(os.path.join(path, "intrinsics.txt"), np.array([[-1.5, -1.4, 0.52, 0.47]]))
        poses = np.zeros((TRACKER_FRAMES, 4, 4))
        for i in range(TRACKER_FRAMES):
            cam = np.array([0.05 * rng.randn(), 0.05 * rng.randn(), 0.6 + 0.05 * rng.randn()])
            p = B.look_at(cam, np.zeros(3))
            p[:, 0] *= -1
            p[:, 2] *= -1
            poses[i] = p
        np.savetxt(os.path.join(path, "rigid.txt"), poses.reshape(TRACKER_FRAMES, -1))
        expr = rng.randn(TRACKER_FRAMES, 76) * 0.3
        expr[3] *= 0.01
        np.savetxt(os.path.join(path, "expression.txt"), expr)
        dirs[name] = path
    return dirs


def test_readers_equal_jax(tracker):
    src = tracker["target"]
    for kw in ({}, dict(im_size=(24, 16)), dict(im_size=(24, 16), center_crop_fix_intrinsics=True)):
        _equal(B.read_intrinsics(os.path.join(src, "intrinsics.txt"), **kw),
               JB.read_intrinsics(os.path.join(src, "intrinsics.txt"), **kw))
    for mean_scale in (True, False):
        _equal(B.read_rigid_poses(os.path.join(src, "rigid.txt"), mean_scale),
               JB.read_rigid_poses(os.path.join(src, "rigid.txt"), mean_scale))
    _equal(B.read_expressions(os.path.join(src, "expression.txt")),
           JB.read_expressions(os.path.join(src, "expression.txt")))
    assert B.read_img_folder(os.path.join(src, "images")) == \
        JB.read_img_folder(os.path.join(src, "images"))


BUILD_CASES = {
    "seeded_mesh": dict(seed=3, reserve_test=4, n_val=3, n_test=1, mesh=True),
    "global_rng": dict(seed=None, reserve_test=0, n_val=2, n_test=2, less_data=0.75),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_dataset_and_sequences_equal_jax(tracker, meshes, tmp_path, case):
    """`build_dataset` then each `generate_*_test_sequence` into the same
    target, port and JAX side by side: every file equal after each step."""
    kw = dict(BUILD_CASES[case])
    mesh = meshes["face_um"] if kw.pop("mesh", False) else None
    cfgs = [mod.BuilderConfig(source=tracker["target"], target=str(tmp_path / side),
                              driving=tracker["driving"], mesh_path=mesh, **kw)
            for mod, side in ((B, "port"), (JB, "jax"))]
    np.random.seed(9)
    idx = B.build_dataset(cfgs[0], log=False)
    np.random.seed(9)
    jidx = JB.build_dataset(cfgs[1], log=False)
    for split in ("train", "val", "test"):
        _equal(idx[split], jidx[split])
    _assert_same_tree(cfgs[0].target, cfgs[1].target)
    if mesh is not None:
        with open(os.path.join(cfgs[0].target, "transforms_train.json")) as f:
            assert any(fr["bbox"] != [0.0, 1.0, 0.0, 1.0] for fr in json.load(f)["frames"])
    steps = [
        ("generate_original_test_sequence", dict(n_max=5)),
        ("generate_custom_test_sequence", dict(n_max=7, sequence="presentation")),
        ("generate_custom_test_sequence",
         dict(sequence="open_mouth_xyz", seq_start=1, neutral_offset=2, steps=3)),
        ("generate_driven_test_sequence", dict(n_max=12)),
    ]
    for fn, skw in steps:
        getattr(B, fn)(cfgs[0], log=False, **skw)
        getattr(JB, fn)(cfgs[1], log=False, **skw)
        _assert_same_tree(cfgs[0].target, cfgs[1].target)
    with pytest.raises(ValueError, match="requires cfg.driving"):
        B.generate_driven_test_sequence(B.BuilderConfig(source=tracker["target"],
                                                        target=str(tmp_path / "x")))


def test_write_debug_overlays_equals_jax(tracker, meshes, tmp_path):
    cfgs = [mod.BuilderConfig(source=tracker["target"], target=str(tmp_path / side),
                              mesh_path=meshes["face_um"])
            for mod, side in ((B, "port"), (JB, "jax"))]
    assert B.write_debug_overlays(cfgs[0], range(3), log=False) == 3
    assert JB.write_debug_overlays(cfgs[1], range(3), log=False) == 3
    _assert_same_tree(cfgs[0].target, cfgs[1].target)
    src = np.asarray(Image.open(os.path.join(tracker["target"], "images", "00000.png")))
    assert (np.asarray(Image.open(tmp_path / "port" / "debug_vis" / "r_0000.png")) != src).any()
    with pytest.raises(ValueError, match="mesh_path"):
        B.write_debug_overlays(B.BuilderConfig(source=tracker["target"], target=str(tmp_path)))


CLI_CASES = {
    "train": ["--mode", "train", "--seed", "1", "--reserve-test", "5", "--LESS_DATA", "0.9"],
    "train_debug_vis": ["--mode", "train", "--seed", "2", "--debug-vis", "2"],
    "original": ["--mode", "original", "--n-max", "6", "--reserve-test", "8"],
    "custom_presentation": ["--mode", "custom", "--sequence", "presentation", "--n-max", "9"],
    "custom_open_mouth": ["--mode", "custom", "--sequence", "open_mouth", "--seq-start", "2",
                          "--neutral-offset", "4"],
    "driven": ["--mode", "driven", "--n-max", "10", "--neutral-driving-idx", "1",
               "--neutral-target-idx", "2"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_build_dataset_cli_equals_jax(tracker, meshes, tmp_path, capsys, case):
    argv = ["--source", tracker["target"], "--driving", tracker["driving"],
            "--mesh", meshes["face_um"]] + CLI_CASES[case]
    build_cli.main(argv + ["--target", str(tmp_path / "port")])
    jax_build_cli.main(argv + ["--target", str(tmp_path / "jax")])
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert capsys.readouterr().out.count("Done.") == 2
    a = vars(build_cli.build_parser().parse_args(argv + ["--target", "t"]))
    assert a == vars(jax_build_cli.build_parser().parse_args(argv + ["--target", "t"]))


# -- mesh and splat datasets, and generate_synthetic --------------------------

def test_mesh_functions_equal_jax(meshes):
    for key in ("ascii", "binary"):
        got = M.load_ply_mesh(meshes[key])
        _equal(got, JM.load_ply_mesh(meshes[key]))
        np.testing.assert_allclose(got[0], meshes["verts"], atol=1e-6)  # f32 in the file
        np.testing.assert_array_equal(got[1], meshes["faces"])
    _equal(M.load_mesh(meshes["off"]), JM.load_mesh(meshes["off"]))
    verts, faces = meshes["verts"] * 3.0 + 1.0, meshes["faces"]
    norm = M.normalize_mesh(verts)
    _equal(norm, JM.normalize_mesh(verts))
    normals = M.vertex_normals(norm, faces)
    _equal(normals, JM.vertex_normals(norm, faces))
    cols = M.shade_vertices(norm, normals)
    _equal(cols, JM.shade_vertices(norm, normals))
    for cam in (np.array([0.0, -1.0, 0.4]), np.array([0.0, 0.0, 2.0])):  # the second along `up`
        pose = M.look_at_pose(cam)
        _equal(pose, JM.look_at_pose(cam))
        img = M.render_shaded(norm, faces, cols, pose, np.array([60.0, 60.0, 20.0, 16.0]), 32, 40)
        _equal(img, JM.render_shaded(norm, faces, cols, pose, np.array([60.0, 60.0, 20.0, 16.0]),
                                     32, 40))
        assert img[..., 3].sum() > 20
    with pytest.raises(ValueError, match="not a PLY file"):
        M.load_ply_mesh(meshes["off"])


@pytest.mark.parametrize("test_sequence", [None, "HELIX"])
def test_generate_mesh_dataset_equals_jax(meshes, tmp_path, test_sequence):
    kw = dict(n_views=6, im_size=24, focal=30.0, seed=4, test_sequence=test_sequence,
              n_views_test=3)
    got = M.generate_mesh_dataset(meshes["binary"], str(tmp_path / "port"), **kw)
    assert got == JM.generate_mesh_dataset(meshes["binary"], str(tmp_path / "jax"), **kw)
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_splat_functions_equal_jax(meshes):
    verts = meshes["verts"] * 2.0 + 0.5
    _equal(P.ritter_bounding_sphere(verts), JP.ritter_bounding_sphere(verts))
    norm = P.normalize_for_splat(verts)
    _equal(norm, JP.normalize_for_splat(verts))
    _equal(P.splat_intrinsics_hom(40), JP.splat_intrinsics_hom(40))
    for cam in (np.array([2.4, 0.9, 3.0]), np.array([0.0, 6.0, 0.0])):  # the second along `tmp`
        c2w = P.look_at_splat(cam, np.zeros(3))
        _equal(c2w, JP.look_at_splat(cam, np.zeros(3)))
        for space in ("world", "cam"):
            got = P.project_and_splat(c2w, P.splat_intrinsics_hom(40), norm, 40, space)
            _equal(got, JP.project_and_splat(c2w, JP.splat_intrinsics_hom(40), norm, 40, space))
            assert (got[2] > 0).sum() > 10


def test_splat_dataset_equals_jax(meshes, tmp_path):
    kw = dict(n_views_train=3, n_views_test=2, im_size=32, render_color=True, focal=40.0,
              log=False)
    got = P.splat_dataset(meshes["off"], str(tmp_path / "port"), **kw)
    assert got == JP.splat_dataset(meshes["off"], str(tmp_path / "jax"), **kw) == \
        {"train": 3, "test": 2}
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


GEN_CASES = {
    "mesh": ["--mesh", "{ply}", "--n-train", "3", "--n-val", "1", "--n-test", "1",
             "--focal", "40"],
    "mesh_helix": ["--mesh", "{off}", "--n-train", "2", "--n-val", "1", "--n-test", "2",
                   "--sampling", "HELIX", "--seed", "2"],
    "splat": ["--splat", "--mesh", "{off}", "--n-train", "2", "--n-test", "1",
              "--render-color", "--coords-space", "cam"],
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_synthetic_mesh_and_splat_equal_jax(meshes, tmp_path, capsys, case):
    argv = [a.format(ply=meshes["ascii"], off=meshes["off"]) for a in GEN_CASES[case]]
    argv += ["--size", "24"]
    gen_cli.main(argv + ["--target", str(tmp_path / "port")])
    jax_gen_cli.main(argv + ["--target", str(tmp_path / "jax")])
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    out = capsys.readouterr().out.replace("port", "jax").splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


# -- dump_rays -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16_tensor"])
def test_dump_rays_equals_jax(tmp_path, kind):
    from nerface_tpu.utils.debug_viz import dump_rays as jax_dump_rays
    from nerface_tpu_torch.utils.debug_viz import dump_rays

    rng = np.random.RandomState(0)
    origins = rng.randn(40, 3).astype(np.float32)
    points = rng.randn(40, 600, 3).astype(np.float32)
    rf = rng.randn(40, 600, 4).astype(np.float32)
    rf[..., 3] = rng.uniform(0.0, 40.0, (40, 600))
    if kind == "numpy":
        args = (origins, points, rf)
    else:
        dtype = torch.bfloat16 if kind == "bf16_tensor" else torch.float32
        args = tuple(torch.as_tensor(a).to(dtype) for a in (origins, points, rf))
        # JAX's side reads the same values, as f32 arrays
        origins, points, rf = (a.float().numpy() for a in args)
    for include in (False, True):
        n = dump_rays(*args, path=str(tmp_path / "port.ply"), stride=3,
                      include_origins=include)
        assert n == jax_dump_rays(origins, points, rf, path=str(tmp_path / "jax.ply"), stride=3,
                                  include_origins=include)
        assert n > 40
        assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()


# -- the public names -----------------------------------------------------------

def test_flame_dataset_hwf_and_tuple_equal_jax(tmp_path):
    from nerface_tpu.data.flame import load_flame_data as jax_load
    from nerface_tpu_torch.data.flame import load_flame_data
    from nerface_tpu_torch.data.synthetic import make_synthetic_flame_dataset

    d = make_synthetic_flame_dataset(str(tmp_path / "ds"), n_train=2, n_val=1, n_test=1, H=8,
                                     W=8)
    got, want = load_flame_data(d), jax_load(d)
    _equal(got.hwf, want.hwf)
    _equal(got.as_tuple(), want.as_tuple())
    assert len(got.as_tuple()) == 8


def test_encoding_names_and_img2mse_equal_jax():
    from nerface_tpu.ops import encoding as JE
    from nerface_tpu.ops.math import img2mse as jax_img2mse
    from nerface_tpu_torch.ops import encoding as E
    from nerface_tpu_torch.ops.math import img2mse

    for d in (1, 3, 76):
        for n in (0, 1, 4, 10):
            for inc in (False, True):
                assert E.encoding_dim(d, n, inc) == JE.encoding_dim(d, n, inc)
    x = np.random.RandomState(1).uniform(-0.6, 0.6, (50, 3)).astype(np.float32)
    for n, inc, log in ((6, True, True), (4, False, False), (0, True, True)):
        got = E.get_embedding_function(n, inc, log)(torch.as_tensor(x)).numpy()
        want = np.asarray(JE.get_embedding_function(n, inc, log)(jnp.asarray(x)))
        assert got.shape == want.shape == (50, E.encoding_dim(3, n, inc))
        np.testing.assert_allclose(got, want, atol=2e-5)  # tests/test_torch_ops.py's tolerance
    a, b = np.random.RandomState(2).rand(2, 4, 5, 3).astype(np.float32)
    np.testing.assert_allclose(float(img2mse(torch.as_tensor(a), torch.as_tensor(b))),
                               float(jax_img2mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_package_exports_the_jax_packages_names():
    """`nerface_tpu_torch` offers every name `nerface_tpu/__init__.py`
    imports, each the port's function of that name, and importing the
    package still imports no torch."""
    import nerface_tpu_torch

    tree = ast.parse(open(os.path.join(ROOT, "nerface_tpu", "__init__.py")).read())
    names = {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names}
    assert names and names == set(nerface_tpu_torch.__all__)
    for name in names:
        obj = getattr(nerface_tpu_torch, name)
        assert obj.__module__.startswith("nerface_tpu_torch.") and obj.__name__ == name
    assert nerface_tpu_torch.__version__ == "0.1.0"
    with pytest.raises(AttributeError):
        nerface_tpu_torch.not_a_name  # noqa: B018
    probe = "import sys, nerface_tpu_torch; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=60, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
