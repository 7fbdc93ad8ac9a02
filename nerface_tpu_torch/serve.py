"""Persistent avatar-rendering server.

Port of `nerface_tpu/serve.py`: a resident process that loads one trained
avatar once and answers render requests — "render this expression under
this pose" — through the same full-frame renderer as batch eval
(`eval/renderer.py`). On the card with `dtype=torch.bfloat16`, both passes
of every tile go through a hand-written kernel: the fused render (K2) for
the paper model, the Flexible family's fused MLP (K4f) for those models.

Protocol: newline-delimited JSON over stdio or TCP, one request per line,
one JSON response per line. Fields (all optional unless noted):

  {"expression": [76 floats]   — defaults to the request frame's / first
                                 test frame's expression
   "pose": 16 or 4x4 floats    — camera-to-world; same default story
   "frame": int                — take pose/expression/latent defaults
                                 from test-split frame i
   "latent_index": int         — row of the trained latent-code table
   "seed": int                 — stream of the stratified samples' draws
   "maps": ["rgb_fine", ...]   — any of rgb_fine/rgb_coarse/disp/depth/
                                 acc/normals (default ["rgb_fine"])
   "fast_eval": bool           — override the server default per request.
                                 The fast path's bbox (and occupancy grid)
                                 is frozen from the TEST-SPLIT poses; send
                                 false with novel poses that may leave it
   "save": "/path/prefix"      — write <prefix><map>.png per map
   "encode": "png_base64"      — inline the maps in the response
   "cmd": "ping" | "stop"}     — health check / shutdown

Responses: {"ok": true, "frame_ms": .., "saved": [..], "maps": {..}} or
{"ok": false, "error": ".."}. A malformed request never kills the server.

Fast-eval + bf16 is the production serving configuration, as in the JAX
package: with `nerf.validation.fast_eval` the server sizes the head-bbox
capacity (and, with `occupancy`, builds the occupancy grid from the trained
field) once at construction (`eval/occupancy.py::fast_eval_setup`), and
only the active rays of each frame run the radiance field. With `devices`
(JAX's `mesh`, `serve.py:322`) every frame, parity or fast, is sharded over
them by the renderer (`render_full_frame(devices=...)`); the avatar lives
on, and the frames land on, `devices[0]`.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import socket
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nerface_tpu_torch.config.flags import EvalFlags
from nerface_tpu_torch.data.flame import load_flame_data
from nerface_tpu_torch.eval.driver import (
    cast_to_disparity_image,
    device_cast_to_image,
    device_uint8,
    load_avatar,
)
from nerface_tpu_torch.eval.normals import normal_map_from_depth
from nerface_tpu_torch.eval.renderer import render_full_frame
from nerface_tpu_torch.render.pipeline import RenderSettings

_KNOWN_MAPS = ("rgb_fine", "rgb_coarse", "disp", "depth", "acc", "normals")


def _u8_unit(x: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(x.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


def _u8_minmax(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    lo, hi = x.min(), x.max()
    return ((x - lo) / torch.clamp(hi - lo, min=1e-8) * 255.0).to(torch.uint8)


def _encode_png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


class AvatarServer:
    """Resident renderer over one reference-schema `.ckpt`.

    Construction mirrors the JAX server's: dataset metadata for intrinsics
    and request defaults, models from cfg, the checkpoint's weights,
    background and latent codes, then the eval flags' background and
    latent-row rules. `device` is where everything lives and renders (the
    card unless the caller asks for the CPU); `dtype=torch.bfloat16`
    selects the kernel path."""

    def __init__(
        self,
        cfg,
        checkpoint: str,
        dataset=None,
        eval_flags: Optional[EvalFlags] = None,
        dtype=None,
        device="cuda",
        log: bool = True,
        devices: Optional[Sequence] = None,
    ):
        self.cfg = cfg
        self.checkpoint = checkpoint
        self.dtype = dtype
        self.devices = [torch.device(d) for d in devices] if devices else None
        self.device = self.devices[0] if self.devices else torch.device(device)
        self.flags = eval_flags if eval_flags is not None else EvalFlags.from_cfg(cfg)

        self.settings = RenderSettings.from_cfg(cfg, mode="validation")

        if dataset is None:
            dataset = load_flame_data(
                cfg.dataset.basedir,
                half_res=cfg.dataset.half_res,
                testskip=cfg.dataset.testskip,
                test=True,
                cachedir=cfg.dataset.get("cachedir"),
            )
        self.dataset = dataset
        self.H, self.W = dataset.H, dataset.W
        self.intrinsics = np.asarray(dataset.intrinsics, np.float32)

        # the eval driver's set-up (one shared helper); the server keeps the
        # JAX server's rule that `no_lcode` is the eval driver's alone
        avatar = load_avatar(cfg, checkpoint, dataset, self.flags, self.device, log=log)
        self.model_coarse, self.model_fine = avatar.model_coarse, avatar.model_fine
        self.latent_codes = avatar.latent_codes
        self.idx_map = avatar.idx_map
        background = avatar.background
        self.background = background.reshape(-1, 3).contiguous() if background is not None else None

        self.fast_bbox = None
        self.occupancy = None
        if self.settings.fast_eval:
            # the eval driver's setup (one shared helper): bbox union and
            # capacity, and the occupancy grid when the config asks for it
            from nerface_tpu_torch.eval.occupancy import fast_eval_setup

            i_test = np.asarray(dataset.i_test)
            self.fast_bbox, self.settings, self.occupancy = fast_eval_setup(
                dataset, np.asarray(dataset.poses)[i_test],
                np.asarray(dataset.expressions)[i_test], self.settings, self.model_coarse,
                latent_codes=self.latent_codes, dtype=self.dtype, log=log, device=self.device,
            )

        i0 = int(np.asarray(dataset.i_test)[0]) if len(dataset.i_test) else 0
        self._default_pose = np.asarray(dataset.poses[i0], np.float32)
        self._default_expression = np.asarray(dataset.expressions[i0], np.float32)
        self._log = log
        self.requests_served = 0

    # ------------------------------------------------------------------
    def _frame_defaults(self, frame: Optional[int]):
        """pose / expression / latent row for test-split frame `frame`."""
        if frame is None:
            pose, expr = self._default_pose, self._default_expression
            frame = 0
        else:
            i_test = np.asarray(self.dataset.i_test)
            if not 0 <= frame < len(i_test):
                raise ValueError(f"frame {frame} out of range [0, {len(i_test)})")
            idx = int(i_test[frame])
            pose = np.asarray(self.dataset.poses[idx], np.float32)
            expr = np.asarray(self.dataset.expressions[idx], np.float32)
        # the eval driver's latent-row rule: the reference's pinned
        # idx_map[10] by default, per-frame rows only when unpinned
        latent_index = 0
        if self.idx_map is not None:
            if self.flags.fix_latent_code_index:
                latent_index = int(self.idx_map[min(10, len(self.idx_map) - 1), 1])
            elif frame < len(self.idx_map) and self.idx_map[frame, 1] >= 0:
                latent_index = int(self.idx_map[frame, 1])
        return pose, expr, max(latent_index, 0)

    def render_async(
        self,
        expression=None,
        pose=None,
        frame: Optional[int] = None,
        latent_index: Optional[int] = None,
        seed: int = 0,
        maps=("rgb_fine",),
        fast_eval: Optional[bool] = None,
    ) -> Dict[str, tuple]:
        """DISPATCH half of a render: enqueue the frame's device work and the
        on-device uint8 casts; returns ("u8" | "disp", tensor) per map. No
        host copy happens here — `finalize_maps` does it.

        `fast_eval=None` takes the server's default. The fast path's bbox,
        capacity and grid are frozen from the test split's poses and
        expressions; a client sending novel ones should pass
        `fast_eval=False` for the full-frame parity renderer."""
        bad = [m for m in maps if m not in _KNOWN_MAPS]
        if bad:
            raise ValueError(f"unknown maps {bad}; known: {_KNOWN_MAPS}")
        settings, bbox, occ = self.settings, self.fast_bbox, self.occupancy
        if fast_eval is not None and bool(fast_eval) != settings.fast_eval:
            if fast_eval and bbox is None:
                raise ValueError(
                    "fast_eval requested but the server was built without "
                    "it (cfg.nerf.validation.fast_eval false)"
                )
            settings = dataclasses.replace(settings, fast_eval=bool(fast_eval))
            if not fast_eval:
                bbox = occ = None
        d_pose, d_expr, d_latent = self._frame_defaults(frame)
        pose = d_pose if pose is None else np.asarray(pose, np.float32).reshape(4, 4)
        expression = d_expr if expression is None else np.asarray(expression, np.float32)
        if expression.shape != d_expr.shape:
            raise ValueError(f"expression shape {expression.shape} != {d_expr.shape}")
        latent_code = None
        if self.latent_codes is not None:
            row = d_latent if latent_index is None else int(latent_index)
            if not 0 <= row < len(self.latent_codes):
                raise ValueError(
                    f"latent_index {row} out of range [0, {len(self.latent_codes)})"
                )
            latent_code = self.latent_codes[row]

        out = render_full_frame(
            self.model_coarse, self.model_fine, self.H, self.W, self.intrinsics,
            pose[:3, :4], settings, seed=int(seed),
            expressions=torch.as_tensor(expression, device=self.device),
            latent_code=latent_code,
            background=self.background,
            dtype=self.dtype,
            device=self.device,
            bbox=bbox,
            occupancy=occ,
            devices=self.devices,
        )
        pending: Dict[str, tuple] = {}
        with torch.no_grad():
            for m in maps:
                if m in ("rgb_fine", "rgb_coarse"):
                    pending[m] = ("u8", device_cast_to_image(out.get(m, out["rgb_coarse"])))
                elif m == "disp":
                    # host float64 min/max normalize (the reference contract)
                    pending[m] = ("disp", out.get("disp_fine", out["disp_coarse"]))
                elif m == "depth":
                    pending[m] = ("u8", _u8_minmax(out.get("depth_fine", out["depth_coarse"])))
                elif m == "acc":
                    pending[m] = ("u8", _u8_unit(out.get("acc_fine", out["acc_coarse"])))
                elif m == "normals":
                    disp = out.get("disp_fine", out["disp_coarse"])
                    normals = normal_map_from_depth(
                        disp, self.intrinsics, out["bg_weight"], clean=True
                    )
                    pending[m] = ("u8", device_uint8(normals))
        self.requests_served += 1
        return pending

    @staticmethod
    def finalize_maps(pending: Dict[str, tuple]) -> Dict[str, np.ndarray]:
        """READBACK half: copy each dispatched map to host uint8."""
        result: Dict[str, np.ndarray] = {}
        for m, (kind, arr) in pending.items():
            arr = arr.cpu().numpy()
            result[m] = cast_to_disparity_image(arr) if kind == "disp" else arr
        return result

    def render(self, **kwargs) -> Dict[str, np.ndarray]:
        """Render one frame synchronously; uint8 maps by name."""
        return self.finalize_maps(self.render_async(**kwargs))

    # ------------------------------------------------------------------
    def handle_split(self, request: dict):
        """(response, finish): exactly one is non-None; neither raises.
        Control commands and errors answer at once (`response`); a render
        returns `finish`, with the device work already enqueued, which
        completes the host half (readback, PNG, response)."""
        try:
            cmd = request.get("cmd")
            if cmd == "ping":
                return {
                    "ok": True, "cmd": "ping",
                    "H": self.H, "W": self.W,
                    "n_test_frames": int(len(self.dataset.i_test)),
                    "n_latent_codes": (
                        int(len(self.latent_codes)) if self.latent_codes is not None else 0
                    ),
                    "fast_eval": bool(self.settings.fast_eval),
                    "device": str(self.device),
                    "requests_served": self.requests_served,
                }, None
            if cmd == "stop":
                return {"ok": True, "cmd": "stop"}, None
            if cmd is not None:
                return {"ok": False, "error": f"unknown cmd {cmd!r}"}, None

            maps = tuple(request.get("maps", ("rgb_fine",)))
            t0 = time.perf_counter()
            pending = self.render_async(
                expression=request.get("expression"),
                pose=request.get("pose"),
                frame=request.get("frame"),
                latent_index=request.get("latent_index"),
                seed=int(request.get("seed", 0)),
                maps=maps,
                fast_eval=request.get("fast_eval"),
            )
        except Exception as e:  # the serving loop must survive bad requests
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}, None

        def finish() -> dict:
            try:
                # the device-to-host copies wait for the render
                rendered = self.finalize_maps(pending)
                frame_ms = (time.perf_counter() - t0) * 1000.0
                response: dict = {"ok": True, "frame_ms": round(frame_ms, 2)}
                save = request.get("save")
                if save:
                    from PIL import Image

                    saved = []
                    for name, img in rendered.items():
                        path = f"{save}{name}.png"
                        Image.fromarray(img).save(path)
                        saved.append(path)
                    response["saved"] = saved
                if request.get("encode") == "png_base64":
                    response["maps"] = {
                        name: {
                            "shape": list(img.shape),
                            "png_base64": base64.b64encode(_encode_png(img)).decode("ascii"),
                        }
                        for name, img in rendered.items()
                    }
                return response
            except Exception as e:
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}

        return None, finish

    def handle(self, request: dict) -> dict:
        """One request dict → one response dict (never raises)."""
        response, finish = self.handle_split(request)
        return response if finish is None else finish()

    def serve_jsonl(self, in_stream, out_stream, max_requests=None) -> int:
        """Serve newline-delimited JSON until EOF, a stop command, or
        `max_requests` requests. Returns the number of requests handled."""
        handled = 0
        for line in in_stream:
            line = line.strip()
            if not line:
                continue
            try:
                request = json.loads(line)
            except json.JSONDecodeError as e:
                response = {"ok": False, "error": f"bad json: {e}"}
            else:
                response = self.handle(request)
            out_stream.write(json.dumps(response) + "\n")
            out_stream.flush()
            handled += 1
            if response.get("cmd") == "stop" and response.get("ok"):
                break
            if max_requests is not None and handled >= max_requests:
                break
        return handled

    def serve_tcp(self, host: str, port: int, max_requests=None) -> int:
        """Serve the JSONL protocol over TCP, pipelined: the selectors loop
        enqueues each render's device work (`handle_split`) and one
        pipeline thread finishes the host half and replies, so request N
        renders while request N-1 is copied back and encoded. Responses
        leave in arrival order; at most 4 requests are in flight. A failing
        connection drops that connection only. Returns the number of
        requests handled."""
        import selectors
        import threading
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        handled = 0
        sel = selectors.DefaultSelector()
        buffers: Dict[socket.socket, bytes] = {}
        dead_lock = threading.Lock()
        dead: set = set()

        def drop(conn):
            try:
                sel.unregister(conn)
            except (KeyError, ValueError):
                pass
            buffers.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

        def send_job(conn, response, finish):
            if finish is not None:
                response = finish()
            try:
                conn.sendall((json.dumps(response) + "\n").encode("utf-8"))
            except OSError as e:
                if self._log:
                    print(f"[serve] connection dropped: {e}", flush=True)
                with dead_lock:
                    dead.add(conn)
            return response

        pipe = ThreadPoolExecutor(max_workers=1, thread_name_prefix="serve-pipe")
        inflight: deque = deque()

        try:
            with socket.create_server((host, port)) as srv:
                srv.setblocking(False)
                sel.register(srv, selectors.EVENT_READ)
                if self._log:
                    print(f"[serve] listening on {host}:{srv.getsockname()[1]}", flush=True)
                stop = False
                while not stop and (max_requests is None or handled < max_requests):
                    events = sel.select(timeout=0.2)
                    with dead_lock:
                        reap, dead = dead, set()
                    for conn in reap:
                        drop(conn)
                    while inflight and inflight[0].done():
                        inflight.popleft().result()
                    for key, _ in events:
                        if key.fileobj is srv:
                            conn, _addr = srv.accept()
                            conn.setblocking(True)  # replies may be large PNGs
                            sel.register(conn, selectors.EVENT_READ)
                            buffers[conn] = b""
                            continue
                        conn = key.fileobj
                        try:
                            data = conn.recv(65536)
                        except OSError:
                            drop(conn)
                            continue
                        if not data:
                            drop(conn)
                            continue
                        buffers[conn] += data
                        while b"\n" in buffers.get(conn, b""):
                            line, buffers[conn] = buffers[conn].split(b"\n", 1)
                            line = line.strip()
                            if not line:
                                continue
                            try:
                                response, finish = self.handle_split(
                                    json.loads(line.decode("utf-8"))
                                )
                            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                                response, finish = {"ok": False, "error": f"bad json: {e}"}, None
                            is_stop = (
                                finish is None
                                and response.get("cmd") == "stop"
                                and response.get("ok")
                            )
                            inflight.append(pipe.submit(send_job, conn, response, finish))
                            handled += 1
                            if is_stop:
                                stop = True
                                break
                            if max_requests is not None and handled >= max_requests:
                                break
                            while len(inflight) > 4:
                                inflight.popleft().result()
                        if stop or (max_requests is not None and handled >= max_requests):
                            break
                while inflight:  # every accepted request is answered
                    inflight.popleft().result()
                for conn in list(buffers):
                    drop(conn)
                sel.unregister(srv)
        finally:
            pipe.shutdown(wait=True)
            sel.close()
        return handled
