"""The auxiliary modules: the image CNN encoder and the latent-code
discriminator probe.

Port of `nerface_tpu/models/encoder.py`: `ImageEncoder` (`models.py:1098-1126`,
B×3×256×256 → B×128×1×1, the code of `ConditionalAutoEncoderNeRFModel`)
and `DiscriminatorModel` (`models.py:1233-1248`, latent → expression; the
reference instantiates it nowhere, but it is part of the model surface).
Both are `nn.Sequential`s, so the state-dict names are the reference's:
`cnn_layers.{0,3,6,9,12}.*` and `model.{0,2,4}.*`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerface_tpu_torch.models.nerf_models import default_init


class ImageEncoder(nn.Module):
    """B×3×256×256 → B×128×1×1: four (conv 4×4 stride 2, relu, max-pool 2)
    stages, a 1×1 conv, tanh."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for ci, co in ((3, 8), (8, 16), (16, 32), (32, 64)):
            layers += [nn.Conv2d(ci, co, 4, stride=2, padding=1, device="meta"), nn.ReLU(),
                       nn.MaxPool2d(2)]
        layers += [nn.Conv2d(64, 128, 1, device="meta"), nn.Tanh()]
        self.cnn_layers = nn.Sequential(*layers)
        self.to_empty(device=device or "cpu")
        default_init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn_layers(x)


class DiscriminatorModel(nn.Module):
    """latent (32) → expression (76) probe: two leaky-relu (0.2) layers of
    2 × dim_latent, then tanh."""

    def __init__(self, dim_latent: int = 32, dim_expressions: int = 76, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_latent = dim_latent
        self.dim_expressions = dim_expressions
        h = dim_latent * 2
        self.model = nn.Sequential(
            nn.Linear(dim_latent, h, device="meta"), nn.LeakyReLU(0.2),
            nn.Linear(h, h, device="meta"), nn.LeakyReLU(0.2),
            nn.Linear(h, dim_expressions, device="meta"), nn.Tanh(),
        )
        self.to_empty(device=device or "cpu")
        default_init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
