"""The NeRFace paper radiance-field model as an `nn.Module`.

Port of `ConditionalBlendshapePaperNeRFModel` from
`nerface_tpu/models/nerf_models.py` (reference `models.py:189-261`):
PE(xyz) ⊕ expr·(1/3) ⊕ 32-d latent code into a 6×256 trunk with a
concat-skip at layer 3, the σ head off `fc_feat`, and a 3×128
view-direction branch to RGB. `state_dict` keys are the reference's
(`layers_xyz.0.weight` … `fc_rgb.bias`), including `layers_dir.3`, which
the reference creates and never applies (`models.py` quirk, kept for
checkpoint parity).

Only this model is ported so far; `build_model` refuses the others and
names the ROADMAP queue that carries them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerface_tpu_torch.models.mlp import cond_contribution, linear, linear_cols

EXPR_DIM = 76
HIDDEN = 256
DIR_HIDDEN = 128


def _xyz_dim(num_encoding_fn_xyz: int, include_input_xyz: bool) -> int:
    return (3 if include_input_xyz else 0) + 2 * 3 * num_encoding_fn_xyz


def _dir_dim(num_encoding_fn_dir: int, include_input_dir: bool) -> int:
    return (3 if include_input_dir else 0) + 2 * 3 * num_encoding_fn_dir


class ConditionalBlendshapePaperNeRFModel(nn.Module):
    """The NeRFace paper model. `num_layers`, `hidden_size` and
    `skip_connect_every` are accepted and ignored, as in the reference
    (its widths are hardcoded). Weights are drawn like `nn.Linear`'s
    default init from `generator` (or the global generator when None)."""

    takes_expression = True
    takes_latent = True
    n_xyz_layers = 6
    skip_at = 3

    def __init__(
        self,
        num_layers=8,
        hidden_size=256,
        skip_connect_every=4,
        num_encoding_fn_xyz=6,
        num_encoding_fn_dir=4,
        include_input_xyz=True,
        include_input_dir=True,
        use_viewdirs=True,
        include_expression=True,
        latent_code_dim=32,
        device=None,
        generator: Optional[torch.Generator] = None,
        **_,
    ):
        super().__init__()
        self.dim_xyz = _xyz_dim(num_encoding_fn_xyz, include_input_xyz)
        self.dim_dir = _dir_dim(num_encoding_fn_dir, include_input_dir)
        self.dim_expression = EXPR_DIM if include_expression else 0
        self.dim_latent_code = latent_code_dim
        self.use_viewdirs = use_viewdirs
        d_in = self.dim_xyz + self.dim_cond

        def lin(i, o):
            return nn.Linear(i, o, device="meta")

        self.layers_xyz = nn.ModuleList(
            [lin(d_in, HIDDEN)]
            + [
                lin(d_in + HIDDEN if i == self.skip_at else HIDDEN, HIDDEN)
                for i in range(1, self.n_xyz_layers)
            ]
        )
        self.fc_feat = lin(HIDDEN, HIDDEN)
        self.fc_alpha = lin(HIDDEN, 1)
        self.layers_dir = nn.ModuleList(
            [lin(HIDDEN + self.dim_dir, DIR_HIDDEN)]
            + [lin(DIR_HIDDEN, DIR_HIDDEN) for _ in range(3)]
        )
        self.fc_rgb = lin(DIR_HIDDEN, 3)
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    @property
    def dim_cond(self) -> int:
        return self.dim_expression + self.dim_latent_code

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """nn.Linear's default distribution, U(-1/sqrt(in), 1/sqrt(in)) for
        weight and bias, drawn from `generator` on the CPU."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_((u * 2.0 - 1.0) * bound)

    def _cond_segments(self, expr, latent):
        segs = []
        if self.dim_expression:
            segs.append((expr * (1.0 / 3.0), self.dim_expression))
        segs.append((latent, self.dim_latent_code))
        return segs

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        """pe_xyz (R, S, Dx) with pe_dir (R, Dd) per ray, or flat rows
        (N, Dx) with pe_dir (N, Dd); expr (76,) and latent (32,) per frame.
        Returns radiance [rgb, σ] of shape (R, S, 4) or (N, 4)."""
        structure = None
        xyz = pe_xyz
        if pe_xyz.ndim == 3:
            structure = pe_xyz.shape[:2]
            xyz = pe_xyz.reshape(-1, pe_xyz.shape[-1])
        segs = self._cond_segments(expr, latent)
        dx = self.dim_xyz

        x = linear_cols(self.layers_xyz[0], xyz, 0, dx, dtype, with_bias=True)
        x = torch.relu(x + cond_contribution(self.layers_xyz[0], segs, dx, dtype))
        for i in range(1, self.n_xyz_layers):
            layer = self.layers_xyz[i]
            if i == self.skip_at:
                # W @ [xyz; expr/3; latent; x] + b
                x = (
                    linear_cols(layer, xyz, 0, dx, dtype, with_bias=True)
                    + cond_contribution(layer, segs, dx, dtype)
                    + linear_cols(
                        layer, x, dx + self.dim_cond, dx + self.dim_cond + HIDDEN, dtype
                    )
                )
            else:
                x = linear(layer, x, dtype)
            x = torch.relu(x)
        feat = linear(self.fc_feat, x, dtype)
        alpha = linear(self.fc_alpha, feat, dtype)
        h = linear_cols(self.layers_dir[0], feat, 0, HIDDEN, dtype, with_bias=True)
        if structure is not None:
            h = h.reshape(*structure, -1)
            alpha = alpha.reshape(*structure, -1)
        if self.use_viewdirs:
            dd = pe_dir.shape[-1]
            contrib = linear_cols(self.layers_dir[0], pe_dir, HIDDEN, HIDDEN + dd, dtype)
            h = h + (contrib[:, None, :] if structure is not None else contrib)
        x = torch.relu(h)
        for i in range(1, 3):
            x = torch.relu(linear(self.layers_dir[i], x, dtype))
        rgb = linear(self.fc_rgb, x, dtype)
        return torch.cat([rgb, alpha], dim=-1)


MODELS = {
    "ConditionalBlendshapePaperNeRFModel": ConditionalBlendshapePaperNeRFModel,
}


def build_model(
    model_cfg, num_layers=None, hidden_size=None, device=None, generator=None
):
    """Instantiate a model from a `cfg.models.coarse`/`.fine` node, with the
    reference entry scripts' kwargs (`train_transformed_rays.py:100-124`):
    `skip_connect_every` is not forwarded, and the fine model takes the
    coarse num_layers/hidden_size when the caller passes them."""
    cls = MODELS.get(model_cfg.type)
    if cls is None:
        raise NotImplementedError(
            f"model type {model_cfg.type!r} is not ported to PyTorch yet; "
            "ROADMAP.md Queue 1 lists the model classes still to port"
        )
    return cls(
        num_encoding_fn_xyz=model_cfg.num_encoding_fn_xyz,
        num_encoding_fn_dir=model_cfg.num_encoding_fn_dir,
        include_input_xyz=model_cfg.include_input_xyz,
        include_input_dir=model_cfg.include_input_dir,
        use_viewdirs=model_cfg.use_viewdirs,
        num_layers=num_layers if num_layers is not None else model_cfg.num_layers,
        hidden_size=hidden_size if hidden_size is not None else model_cfg.hidden_size,
        include_expression=True,
        device=device,
        generator=generator,
    )
