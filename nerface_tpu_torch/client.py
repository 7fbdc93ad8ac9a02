"""Client for the avatar render server (`nerface_tpu_torch/serve.py`), a
copy of `nerface_tpu/client.py`: the newline-JSON protocol of
`AvatarServer.serve_tcp` over TCP, request dicts out, responses back with
their inline PNGs decoded to numpy arrays.

    from nerface_tpu_torch.client import AvatarClient

    with AvatarClient("gpu-host", 7860) as client:
        client.ping()
        frames = client.render(expression=expr76, maps=("rgb_fine",))
        frames["rgb_fine"]  # (H, W, 3) uint8
"""

from __future__ import annotations

import base64
import io
import json
import socket
from typing import Dict, Optional


class AvatarClient:
    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._conn = socket.create_connection((host, port), timeout=timeout)
        self._stream = self._conn.makefile("rw", encoding="utf-8")

    def request(self, req: dict) -> dict:
        """Send one raw request dict; return the raw response dict."""
        self._stream.write(json.dumps(req) + "\n")
        self._stream.flush()
        line = self._stream.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def ping(self) -> dict:
        r = self.request({"cmd": "ping"})
        if not r.get("ok"):
            raise RuntimeError(f"ping failed: {r.get('error')}")
        return r

    def render(
        self,
        expression=None,
        pose=None,
        frame: Optional[int] = None,
        latent_index: Optional[int] = None,
        seed: int = 0,
        maps=("rgb_fine",),
    ) -> Dict[str, "np.ndarray"]:
        """Render one frame; returns {map name: uint8 array} decoded from
        the server's inline PNGs."""
        import numpy as np
        from PIL import Image

        req = {"seed": seed, "maps": list(maps), "encode": "png_base64"}
        if expression is not None:
            req["expression"] = np.asarray(expression, np.float32).reshape(-1).tolist()
        if pose is not None:
            req["pose"] = np.asarray(pose, np.float32).reshape(-1).tolist()
        if frame is not None:
            req["frame"] = int(frame)
        if latent_index is not None:
            req["latent_index"] = int(latent_index)
        r = self.request(req)
        if not r.get("ok"):
            raise RuntimeError(f"render failed: {r.get('error')}")
        out = {}
        for name, payload in r["maps"].items():
            img = np.asarray(
                Image.open(io.BytesIO(base64.b64decode(payload["png_base64"])))
            )
            out[name] = img
        return out

    def stop_server(self) -> None:
        self.request({"cmd": "stop"})

    def close(self) -> None:
        try:
            self._stream.close()
        finally:
            self._conn.close()

    def __enter__(self) -> "AvatarClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
