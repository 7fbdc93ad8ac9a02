"""The radiance-field models as `nn.Module`s.

Ports of `nerface_tpu/models/nerf_models.py` (reference `models.py`):

* `ConditionalBlendshapePaperNeRFModel` (`models.py:189-261`): PE(xyz) ⊕
  expr·(1/3) ⊕ 32-d latent code into a 6×256 trunk with a concat-skip at
  layer 3, the σ head off `fc_feat`, and a 3×128 view-direction branch to
  RGB. Its state dict keeps `layers_dir.3`, which the reference creates
  and never applies (`models.py` quirk, kept for checkpoint parity).
* `ConditionalBlendshapePaperSmallerNeRFModel` (`models.py:266-338`): the
  same with 5 trunk layers, and the expression fed again into the
  direction branch, whose first layer reads [feat; dirs; expr/3].
* The Flexible family (`_FlexibleFamily` and its 8 subclasses,
  `models.py:351-1230`): `layer1` + (num_layers − 1) hidden layers with
  periodic concat-skips, then a view-direction head or `fc_out`, each
  subclass folding its own conditioning into `layer1` and the skips.

`state_dict` keys are the reference's, registered in the order of the JAX
package's `init` dict (the Adam parameter order). `build_model` refuses
the classes still to port and names the ROADMAP queue that carries them.
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


class _ModelBase(nn.Module):
    """Which per-frame inputs a model reads, and `nn.Linear`'s default
    init drawn from a given generator."""

    takes_expression = False
    takes_latent = False

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """nn.Linear's default distribution, U(-1/sqrt(in), 1/sqrt(in)) for
        weight and bias, drawn from `generator` on the CPU in registration
        order."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_((u * 2.0 - 1.0) * bound)


def _lin(i: int, o: int) -> nn.Linear:
    return nn.Linear(i, o, device="meta")


def _flatten_xyz(pe_xyz: torch.Tensor):
    """(R, S, D) -> ((R·S, D), (R, S)) | (N, D) -> ((N, D), None)."""
    if pe_xyz.ndim == 3:
        return pe_xyz.reshape(-1, pe_xyz.shape[-1]), pe_xyz.shape[:2]
    return pe_xyz, None


class ConditionalBlendshapePaperNeRFModel(_ModelBase):
    """The NeRFace paper model. `num_layers`, `hidden_size` and
    `skip_connect_every` are accepted and ignored, as in the reference
    (its widths are hardcoded). Weights are drawn like `nn.Linear`'s
    default init from `generator` (or the global generator when None)."""

    takes_expression = True
    takes_latent = True
    n_xyz_layers = 6
    skip_at = 3
    # layers_dir.0 and the 128-wide layers after it, applied or not
    n_dir_layers = 4
    # whether layers_dir.0 also reads expr/3 after the direction columns
    dir_takes_expression = False

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
        self.layers_xyz = nn.ModuleList(
            [_lin(d_in, HIDDEN)]
            + [
                _lin(d_in + HIDDEN if i == self.skip_at else HIDDEN, HIDDEN)
                for i in range(1, self.n_xyz_layers)
            ]
        )
        self.fc_feat = _lin(HIDDEN, HIDDEN)
        self.fc_alpha = _lin(HIDDEN, 1)
        d_dir0 = HIDDEN + self.dim_dir + (self.dim_expression if self.dir_takes_expression else 0)
        self.layers_dir = nn.ModuleList(
            [_lin(d_dir0, DIR_HIDDEN)]
            + [_lin(DIR_HIDDEN, DIR_HIDDEN) for _ in range(self.n_dir_layers - 1)]
        )
        self.fc_rgb = _lin(DIR_HIDDEN, 3)
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    @property
    def dim_cond(self) -> int:
        return self.dim_expression + self.dim_latent_code

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
        xyz, structure = _flatten_xyz(pe_xyz)
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
            if self.dir_takes_expression and self.dim_expression:
                h = h + cond_contribution(
                    self.layers_dir[0], [(expr * (1.0 / 3.0), self.dim_expression)],
                    HIDDEN + self.dim_dir, dtype,
                )
        x = torch.relu(h)
        for i in range(1, 3):
            x = torch.relu(linear(self.layers_dir[i], x, dtype))
        rgb = linear(self.fc_rgb, x, dtype)
        return torch.cat([rgb, alpha], dim=-1)


class ConditionalBlendshapePaperSmallerNeRFModel(ConditionalBlendshapePaperNeRFModel):
    """The smaller paper model: 5 trunk layers (the skip at 3), and
    layers_dir.0 reads [feat; dirs; expr/3] (`models.py:330`); 3 direction
    layers, none unused."""

    n_xyz_layers = 5
    n_dir_layers = 3
    dir_takes_expression = True


class _FlexibleFamily(_ModelBase):
    """The FlexibleNeRFModel-shaped variants (`models.py:351-422` and the
    conditional offshoots): `layer1` + (num_layers − 1) hidden layers with
    periodic concat-skips, then either a view-direction head
    (fc_feat/fc_alpha/layers_dir.0/fc_rgb) or `fc_out`.

    Subclasses set the conditioning widths in `_set_conditioning` and
    define what is folded into `layer1` and into the skip concat. The
    reference's quirks are kept: no activation after `layer1`; the skip
    concat order (x, xyz, cond); σ off the trunk, not off `fc_feat`; and
    skip-layer weights sized by `cond_dim_skip_init` while the forward
    concatenates only `cond_dim_skip`."""

    # Conditioning widths: input concat to layer1 beyond PE(xyz); extra
    # concat at skip layers beyond [x; xyz]; the width the init reserves
    # at skip layers (None: cond_dim_skip).
    cond_dim_layer1 = 0
    cond_dim_skip = 0
    cond_dim_skip_init = None

    def __init__(
        self,
        num_layers=4,
        hidden_size=128,
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
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_connect_every = skip_connect_every
        self.dim_xyz = _xyz_dim(num_encoding_fn_xyz, include_input_xyz)
        self.dim_dir = _dir_dim(num_encoding_fn_dir, include_input_dir) if use_viewdirs else 0
        self.use_viewdirs = use_viewdirs
        self._set_conditioning(include_expression, latent_code_dim)
        h = hidden_size
        skip_init = (
            self.cond_dim_skip if self.cond_dim_skip_init is None else self.cond_dim_skip_init
        )
        self.layer1 = _lin(self.dim_xyz + self.cond_dim_layer1, h)
        self.layers_xyz = nn.ModuleList(
            [
                _lin(self.dim_xyz + h + skip_init if self._is_skip_init(i) else h, h)
                for i in range(num_layers - 1)
            ]
        )
        if use_viewdirs:
            self.layers_dir = nn.ModuleList([_lin(self.dim_dir + h, h // 2)])
            self.fc_alpha = _lin(h, 1)
            self.fc_rgb = _lin(h // 2, 3)
            self.fc_feat = _lin(h, h)
        else:
            self.fc_out = _lin(h, 4)
        self._add_extra_layers()
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    # -- hooks ---------------------------------------------------------------

    def _set_conditioning(self, include_expression: bool, latent_code_dim: int) -> None:
        pass

    def _add_extra_layers(self) -> None:
        pass

    def _cond_segments_layer1(self, expr, latent):
        return []

    def _cond_segments_skip(self, expr, latent):
        return []

    def _prepare(self, expr, latent, dtype):
        """Preprocessing of the conditioning (the expression compressors);
        returns the (expr, latent) actually concatenated."""
        return expr, latent

    # -- forward -------------------------------------------------------------

    def _is_skip_init(self, i: int) -> bool:
        return i % self.skip_connect_every == 0 and i > 0 and i != self.num_layers - 1

    def _is_skip_forward(self, i: int, n_hidden: int) -> bool:
        return i % self.skip_connect_every == 0 and i > 0 and i != n_hidden - 1

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        """pe_xyz (R, S, Dx) with pe_dir (R, Dd) per ray, or flat rows
        (N, Dx) with pe_dir (N, Dd); per-frame expr and latent (1-D).
        Returns radiance [rgb, σ] of shape (R, S, 4) or (N, 4)."""
        xyz, structure = _flatten_xyz(pe_xyz)
        expr, latent = self._prepare(expr, latent, dtype)
        dx, h = self.dim_xyz, self.hidden_size
        n_hidden = self.num_layers - 1

        x = linear_cols(self.layer1, xyz, 0, dx, dtype, with_bias=True)
        segs1 = self._cond_segments_layer1(expr, latent)
        if segs1:
            x = x + cond_contribution(self.layer1, segs1, dx, dtype)
        # Reference quirk: no activation after layer1 (`models.py:404,509`).
        for i in range(n_hidden):
            layer = self.layers_xyz[i]
            if self._is_skip_forward(i, n_hidden):
                # concat order in the reference is (x, xyz[, cond])
                y = (
                    linear_cols(layer, x, 0, h, dtype, with_bias=True)
                    + linear_cols(layer, xyz, h, h + dx, dtype)
                )
                segs_s = self._cond_segments_skip(expr, latent)
                if segs_s:
                    y = y + cond_contribution(layer, segs_s, h + dx, dtype)
                x = y
            else:
                x = linear(layer, x, dtype)
            x = torch.relu(x)
        if not self.use_viewdirs:
            out = linear(self.fc_out, x, dtype)
            return out.reshape(*structure, -1) if structure is not None else out
        feat = torch.relu(linear(self.fc_feat, x, dtype))
        alpha = linear(self.fc_alpha, x, dtype)  # σ off the trunk (`models.py:414-415`)
        # layers_dir.0 input: [feat; view] (`models.py:416`)
        y = linear_cols(self.layers_dir[0], feat, 0, h, dtype, with_bias=True)
        if structure is not None:
            y = y.reshape(*structure, -1)
            alpha = alpha.reshape(*structure, -1)
        dd = pe_dir.shape[-1]
        contrib = linear_cols(self.layers_dir[0], pe_dir, h, h + dd, dtype)
        y = y + (contrib[:, None, :] if structure is not None else contrib)
        rgb = linear(self.fc_rgb, torch.relu(y), dtype)
        return torch.cat([rgb, alpha], dim=-1)


class FlexibleNeRFModel(_FlexibleFamily):
    """`models.py:351-422`."""


class ConditionalNeRFModel(_FlexibleFamily):
    """`models.py:425-527`: dim_expression is force-set to 0 (:447), so the
    expression input is accepted and ignored."""

    takes_expression = True


class ConditionalBlendshapeNeRFModel(_FlexibleFamily):
    """`models.py:872-976`: expr·(1/3) concatenated at layer1 and at skips."""

    takes_expression = True

    def _set_conditioning(self, include_expression, latent_code_dim):
        self.dim_expression = EXPR_DIM if include_expression else 0
        self.cond_dim_layer1 = self.cond_dim_skip = self.dim_expression

    def _cond_segments_layer1(self, expr, latent):
        if not self.dim_expression:
            return []
        return [(expr * (1.0 / 3.0), self.dim_expression)]

    _cond_segments_skip = _cond_segments_layer1


class ConditionalBlendshapeLearnableCodeNeRFModel(_FlexibleFamily):
    """`models.py:529-636`: expr·(1/3) ⊕ latent code at layer1.

    Reference inconsistency kept: skip-layer weights are sized for
    [xyz; h; expr; latent] (:572) but the forward concatenates only
    (x, xyz, expr) (:625); the shipped configs have no skip layer."""

    takes_expression = True
    takes_latent = True

    def _set_conditioning(self, include_expression, latent_code_dim):
        self.dim_expression = EXPR_DIM if include_expression else 0
        self.dim_latent_code = latent_code_dim
        self.cond_dim_layer1 = self.dim_expression + self.dim_latent_code
        self.cond_dim_skip = self.dim_expression
        self.cond_dim_skip_init = self.dim_expression + self.dim_latent_code

    def _cond_segments_layer1(self, expr, latent):
        segs = []
        if self.dim_expression:
            segs.append((expr * (1.0 / 3.0), self.dim_expression))
        segs.append((latent, self.dim_latent_code))
        return segs

    def _cond_segments_skip(self, expr, latent):
        if not self.dim_expression:
            return []
        return [(expr * (1.0 / 3.0), self.dim_expression)]


class ConditionalCompressedBlendshapeLearnableCodeNeRFModel(_FlexibleFamily):
    """`models.py:639-747`: the 76-dim expression compressed to 10 by one
    linear layer (:670-671,714, no activation), then ⊕ latent code."""

    takes_expression = True
    takes_latent = True
    compressed_dim = 10

    def _set_conditioning(self, include_expression, latent_code_dim):
        self.dim_expression = self.compressed_dim if include_expression else 0
        self.dim_latent_code = latent_code_dim
        self.cond_dim_layer1 = self.dim_expression + self.dim_latent_code
        self.cond_dim_skip = self.dim_expression
        self.cond_dim_skip_init = self.dim_expression + self.dim_latent_code

    def _add_extra_layers(self):
        self.layer_expr = _lin(EXPR_DIM, self.compressed_dim)

    def _prepare(self, expr, latent, dtype):
        if self.dim_expression and expr is not None:
            expr = linear(self.layer_expr, expr, dtype)
        return expr, latent

    def _cond_segments_layer1(self, expr, latent):
        segs = []
        if self.dim_expression:
            segs.append((expr, self.dim_expression))  # no 1/3 scale (:714)
        segs.append((latent, self.dim_latent_code))
        return segs

    def _cond_segments_skip(self, expr, latent):
        if not self.dim_expression:
            return []
        return [(expr, self.dim_expression)]


class ConditionalCompressedBlendshapeNeRFModel(_FlexibleFamily):
    """`models.py:750-868`: the expression compressed 76→38→20→20 with a
    ReLU after every stage (:782-786,832-834), no latent code."""

    takes_expression = True
    compressed_dim = 20

    def _set_conditioning(self, include_expression, latent_code_dim):
        self.dim_expression = self.compressed_dim
        self.cond_dim_layer1 = self.cond_dim_skip = self.dim_expression

    def _add_extra_layers(self):
        self.layers_expr = nn.ModuleList([_lin(EXPR_DIM, 38), _lin(38, 20), _lin(20, 20)])

    def _prepare(self, expr, latent, dtype):
        if expr is not None:
            for layer in self.layers_expr:
                expr = torch.relu(linear(layer, expr, dtype))
        return expr, latent

    def _cond_segments_layer1(self, expr, latent):
        return [(expr, self.dim_expression)]

    _cond_segments_skip = _cond_segments_layer1


class ConditionalBlendshapeNeRFModel_v2(_FlexibleFamily):
    """`models.py:991-1095`: a 15-dim expression expanded 15→30→60 with
    ReLUs (:1019-1023,1067-1072); skips concatenate only (x, xyz) (:1084)."""

    takes_expression = True
    base_expr_dim = 15

    def _set_conditioning(self, include_expression, latent_code_dim):
        self.dim_expression = self.base_expr_dim * 4 if include_expression else 0
        self.cond_dim_layer1 = self.dim_expression

    def _add_extra_layers(self):
        e = self.base_expr_dim
        self.layers_expr = nn.ModuleList([_lin(e, e * 2), _lin(e * 2, e * 4)])

    def _prepare(self, expr, latent, dtype):
        if self.dim_expression and expr is not None:
            expr = expr * (1.0 / 3.0)
            for layer in self.layers_expr:
                expr = torch.relu(linear(layer, expr, dtype))
        return expr, latent

    def _cond_segments_layer1(self, expr, latent):
        if not self.dim_expression:
            return []
        return [(expr, self.dim_expression)]


class ConditionalAutoEncoderNeRFModel(_FlexibleFamily):
    """`models.py:1128-1230`: dim_expression is force-set to 0 (:1150); the
    128-dim ImageEncoder code input is accepted and ignored, matching the
    released forward path."""

    takes_expression = True


MODELS = {
    "ConditionalBlendshapePaperNeRFModel": ConditionalBlendshapePaperNeRFModel,
    "ConditionalBlendshapePaperSmallerNeRFModel": ConditionalBlendshapePaperSmallerNeRFModel,
    "FlexibleNeRFModel": FlexibleNeRFModel,
    "ConditionalNeRFModel": ConditionalNeRFModel,
    "ConditionalBlendshapeLearnableCodeNeRFModel": ConditionalBlendshapeLearnableCodeNeRFModel,
    "ConditionalCompressedBlendshapeLearnableCodeNeRFModel": (
        ConditionalCompressedBlendshapeLearnableCodeNeRFModel
    ),
    "ConditionalCompressedBlendshapeNeRFModel": ConditionalCompressedBlendshapeNeRFModel,
    "ConditionalBlendshapeNeRFModel": ConditionalBlendshapeNeRFModel,
    "ConditionalBlendshapeNeRFModel_v2": ConditionalBlendshapeNeRFModel_v2,
    "ConditionalAutoEncoderNeRFModel": ConditionalAutoEncoderNeRFModel,
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
