"""LPIPS with the AlexNet backbone.

Port of `nerface_tpu/metrics/lpips.py` (the reference uses the `lpips`
package with pretrained AlexNet, `nerf/metrics.py:15,64-76,172`): AlexNet's
features, unit-normalised activations, per-layer 1×1 linear heads and the
input scaling layer. The weights are not in the repository and cannot be
fetched here, so they load from a file the user gives: one combined state
dict made by `export_combined` (AlexNet's `features.*` as `net.*`, and the
heads `lin{i}.model.1.weight`). Without it `lpips_available()` is False and
the harness reports LPIPS as nan.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

_ALEX_CHANNELS = [64, 192, 384, 256, 256]
# LPIPS's ScalingLayer (ImageNet-style input shift and scale)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_available(weights_path: Optional[str] = None) -> bool:
    return bool(weights_path) and os.path.exists(weights_path)


def export_combined(alexnet_weights: str, lpips_weights: str, out_path: str) -> None:
    """Merge a torchvision AlexNet state dict (`features.N.{weight,bias}`)
    and an lpips-package checkpoint (`lin{i}.model.1.weight`, e.g.
    `lpips/weights/v0.1/alex.pth`) into one file that `LPIPSAlex` loads."""
    alex_sd = torch.load(alexnet_weights, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lpips_weights, map_location="cpu", weights_only=True)
    combined = {f"net.{k}": v for k, v in alex_sd.items() if k.startswith("features.")}
    for i in range(5):
        w = lin_sd.get(f"lin{i}.model.1.weight", lin_sd.get(f"lins.{i}.weight"))
        if w is None:
            raise ValueError(f"missing linear head {i} in {lpips_weights}")
        combined[f"lin{i}.model.1.weight"] = w
    torch.save(combined, out_path)


class _AlexFeatures(nn.Module):
    # ReLU outputs tapped after these layers of `features`
    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(inplace=True), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(inplace=True), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(inplace=True),
        )

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.TAPS:
                outs.append(x)
        return outs


class LPIPSAlex:
    """LPIPS-alex scorer over a combined state dict (`net.*` and
    `lin*.model.1.weight`), evaluated on `device` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, weights_path: str, device="cuda"):
        self.device = torch.device(device)
        self.net = _AlexFeatures().eval()
        self.lins = [nn.Conv2d(c, 1, 1, bias=False).eval() for c in _ALEX_CHANNELS]
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        # lpips-package layout: net.<slice>.<layer id>.* indexed by the
        # global layer id, as is `export_combined`'s net.features.<id>.*
        net_sd = {}
        for k, v in sd.items():
            if k.startswith("net."):
                parts = k.split(".")
                net_sd[f"features.{parts[-2]}.{parts[-1]}"] = v
        if net_sd:
            self.net.load_state_dict(net_sd)
        for i, lin in enumerate(self.lins):
            w = sd.get(f"lin{i}.model.1.weight", sd.get(f"lins.{i}.weight"))
            if w is None:
                raise ValueError(f"missing linear head {i} in {weights_path}")
            lin.weight.data = w
        self.net.to(self.device)
        for lin in self.lins:
            lin.to(self.device)
        self._shift = torch.tensor(_SHIFT, device=self.device).view(1, 3, 1, 1)
        self._scale = torch.tensor(_SCALE, device=self.device).view(1, 3, 1, 1)

    @staticmethod
    def _normalize(x, eps=1e-10):
        return x / ((x**2).sum(dim=1, keepdim=True).sqrt() + eps)

    def __call__(self, im1: np.ndarray, im2: np.ndarray) -> float:
        """im1 / im2: (H, W, 3) floats in [0, 1]; returns the distance.
        The reference feeds [0, 1] images straight in (the lpips package
        expects [-1, 1]); kept as it is (`metrics.py:64-76`)."""

        def prep(im):
            t = torch.from_numpy(np.asarray(im, np.float32)).permute(2, 0, 1)[None]
            return (t.to(self.device) - self._shift) / self._scale

        with torch.no_grad():
            total = 0.0
            for a, b, lin in zip(self.net(prep(im1)), self.net(prep(im2)), self.lins):
                d = (self._normalize(a) - self._normalize(b)) ** 2
                total = total + lin(d).mean(dim=(2, 3))
        return float(total.item())
