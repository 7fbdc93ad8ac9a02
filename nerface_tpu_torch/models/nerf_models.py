"""The radiance-field models as `nn.Module`s.

Ports of the 14 classes of `nerface_tpu/models/nerf_models.py` (reference
`models.py`):

* the stock NeRF models `VeryTinyNeRFModel` (`models.py:4-31`),
  `MultiHeadNeRFModel` (:34-78), `ReplicateNeRFModel` (:81-121) and
  `PaperNeRFModel` (:124-184), with the reference's quirks: VeryTiny's
  width is `filter_size` (a `hidden_size` is swallowed), and the paper
  model hardcodes 256 / 128 and creates `layers_dir.3`, which it never
  applies;
* `ConditionalBlendshapePaperNeRFModel` (`models.py:189-261`): PE(xyz) ⊕
  expr·(1/3) ⊕ 32-d latent code into a 6×256 trunk with a concat-skip at
  layer 3, the σ head off `fc_feat`, and a 3×128 view-direction branch to
  RGB. Its state dict keeps `layers_dir.3` too;
* `ConditionalBlendshapePaperSmallerNeRFModel` (`models.py:266-338`): the
  same with 5 trunk layers, and the expression fed again into the
  direction branch, whose first layer reads [feat; dirs; expr/3];
* the Flexible family (`_FlexibleFamily` and its 8 subclasses,
  `models.py:351-1230`): `layer1` + (num_layers − 1) hidden layers with
  periodic concat-skips, then a view-direction head or `fc_out`, each
  subclass folding its own conditioning into `layer1` and the skips.

Every class takes flat rows (N, D) with pe_dir (N, Dd), or the structured
(R, S, D) layout with pe_dir (R, Dd), whose direction contribution is
computed once a ray and broadcast over the samples. `state_dict` keys are
the reference's, registered in the order of the JAX package's `init` dict
(the Adam parameter order). The stock models take no expression or latent
code (`takes_expression` / `takes_latent` False), and no kernel takes them
(the kernels' gates admit the paper and Flexible families only): they run
as PyTorch ops, as they run as XLA ops in the JAX package.
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

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        default_init(self, generator)


@torch.no_grad()
def default_init(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """nn.Linear's and nn.Conv2d's default distribution, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weight and bias, drawn from `generator` on the CPU
    in registration order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
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


def _dir_contrib(layer: nn.Linear, pe_dir, col_start: int, structure, dtype):
    """Columns [col_start, col_start + Dd) of `layer` applied to pe_dir: per
    ray (R, 1, out), broadcast over the samples, with structured input;
    per row (N, out) otherwise."""
    contrib = linear_cols(layer, pe_dir, col_start, col_start + pe_dir.shape[-1], dtype)
    return contrib[:, None, :] if structure is not None else contrib


class VeryTinyNeRFModel(_ModelBase):
    """Three-layer toy NeRF (`models.py:4-31`)."""

    def __init__(self, filter_size=128, num_encoding_functions=6, use_viewdirs=True,
                 device=None, generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        self.filter_size = filter_size
        self.dim_xyz = 3 + 3 * 2 * num_encoding_functions
        self.dim_dir = (3 + 3 * 2 * num_encoding_functions) if use_viewdirs else 0
        self.use_viewdirs = use_viewdirs
        self.layer1 = _lin(self.dim_xyz + self.dim_dir, filter_size)
        self.layer2 = _lin(filter_size, filter_size)
        self.layer3 = _lin(filter_size, 4)
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        x, structure = _flatten_xyz(pe_xyz)
        h = linear_cols(self.layer1, x, 0, self.dim_xyz, dtype, with_bias=True)
        if structure is not None:
            h = h.reshape(*structure, -1)
        if self.use_viewdirs and self.dim_dir:
            h = h + _dir_contrib(self.layer1, pe_dir, self.dim_xyz, structure, dtype)
        x = torch.relu(h)
        x = torch.relu(linear(self.layer2, x, dtype))
        return linear(self.layer3, x, dtype)


class MultiHeadNeRFModel(_ModelBase):
    """Separate σ and RGB heads (`models.py:34-78`)."""

    def __init__(self, hidden_size=128, num_encoding_functions=6, use_viewdirs=True,
                 device=None, generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        h = self.hidden_size = hidden_size
        self.dim_xyz = 3 + 3 * 2 * num_encoding_functions
        self.dim_dir = (3 + 3 * 2 * num_encoding_functions) if use_viewdirs else 0
        self.use_viewdirs = use_viewdirs
        self.layer1 = _lin(self.dim_xyz, h)
        self.layer2 = _lin(h, h)
        self.layer3_1 = _lin(h, 1)
        self.layer3_2 = _lin(h, h)
        self.layer4 = _lin(self.dim_dir + h, h)
        self.layer5 = _lin(h, h)
        self.layer6 = _lin(h, 3)
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        x, structure = _flatten_xyz(pe_xyz)
        x = torch.relu(linear(self.layer1, x, dtype))
        x = torch.relu(linear(self.layer2, x, dtype))
        sigma = linear(self.layer3_1, x, dtype)
        feat = torch.relu(linear(self.layer3_2, x, dtype))
        # layer4 reads [feat; view]
        h = linear_cols(self.layer4, feat, 0, self.hidden_size, dtype, with_bias=True)
        if structure is not None:
            h = h.reshape(*structure, -1)
            sigma = sigma.reshape(*structure, -1)
        if self.dim_dir:
            h = h + _dir_contrib(self.layer4, pe_dir, self.hidden_size, structure, dtype)
        x = torch.relu(h)
        x = torch.relu(linear(self.layer5, x, dtype))
        return torch.cat([linear(self.layer6, x, dtype), sigma], dim=-1)


class ReplicateNeRFModel(_ModelBase):
    """The NeRF supplementary figure's model (`models.py:81-121`)."""

    def __init__(self, hidden_size=256, num_layers=4, num_encoding_fn_xyz=6,
                 num_encoding_fn_dir=4, include_input_xyz=True, include_input_dir=True,
                 device=None, generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        h = self.hidden_size = hidden_size
        self.dim_xyz = _xyz_dim(num_encoding_fn_xyz, include_input_xyz)
        self.dim_dir = _dir_dim(num_encoding_fn_dir, include_input_dir)
        self.layer1 = _lin(self.dim_xyz, h)
        self.layer2 = _lin(h, h)
        self.layer3 = _lin(h, h)
        self.fc_alpha = _lin(h, 1)
        self.layer4 = _lin(h + self.dim_dir, h // 2)
        self.layer5 = _lin(h // 2, h // 2)
        self.fc_rgb = _lin(h // 2, 3)
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        x, structure = _flatten_xyz(pe_xyz)
        x_ = torch.relu(linear(self.layer1, x, dtype))
        x_ = torch.relu(linear(self.layer2, x_, dtype))
        feat = linear(self.layer3, x_, dtype)
        alpha = linear(self.fc_alpha, x_, dtype)  # σ off layer2's output, as the reference
        h = linear_cols(self.layer4, feat, 0, self.hidden_size, dtype, with_bias=True)
        if structure is not None:
            h = h.reshape(*structure, -1)
            alpha = alpha.reshape(*structure, -1)
        h = h + _dir_contrib(self.layer4, pe_dir, self.hidden_size, structure, dtype)
        y = torch.relu(h)
        y = torch.relu(linear(self.layer5, y, dtype))
        return torch.cat([linear(self.fc_rgb, y, dtype), alpha], dim=-1)


class PaperNeRFModel(_ModelBase):
    """The NeRF paper's Fig. 7 model (`models.py:124-184`): a 6×256 trunk
    with a concat-skip [xyz; x] at layer 3, σ off `fc_feat`, and a 3×128
    view-direction branch. `num_layers`, `hidden_size` and
    `skip_connect_every` are accepted and ignored (the widths are
    hardcoded); `layers_dir.3` is created and never applied."""

    n_xyz_layers = 6
    skip_at = 3

    def __init__(self, num_layers=8, hidden_size=256, skip_connect_every=4,
                 num_encoding_fn_xyz=6, num_encoding_fn_dir=4, include_input_xyz=True,
                 include_input_dir=True, use_viewdirs=True, device=None,
                 generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        self.dim_xyz = _xyz_dim(num_encoding_fn_xyz, include_input_xyz)
        self.dim_dir = _dir_dim(num_encoding_fn_dir, include_input_dir)
        self.use_viewdirs = use_viewdirs
        self.layers_xyz = nn.ModuleList(
            [_lin(self.dim_xyz, HIDDEN)]
            + [
                _lin(self.dim_xyz + HIDDEN if i == self.skip_at else HIDDEN, HIDDEN)
                for i in range(1, self.n_xyz_layers)
            ]
        )
        self.fc_feat = _lin(HIDDEN, HIDDEN)
        self.fc_alpha = _lin(HIDDEN, 1)
        self.layers_dir = nn.ModuleList(
            [_lin(HIDDEN + self.dim_dir, DIR_HIDDEN)]
            + [_lin(DIR_HIDDEN, DIR_HIDDEN) for _ in range(3)]
        )
        self.fc_rgb = _lin(DIR_HIDDEN, 3)
        self.to_empty(device=device or "cpu")
        self.reset_parameters(generator)

    def forward(self, pe_xyz, pe_dir, expr=None, latent=None, dtype=None):
        xyz, structure = _flatten_xyz(pe_xyz)
        dx = self.dim_xyz
        x = xyz
        for i, layer in enumerate(self.layers_xyz):
            if i == self.skip_at:
                # W @ [xyz; x] + b
                x = linear_cols(layer, xyz, 0, dx, dtype) + linear_cols(
                    layer, x, dx, dx + HIDDEN, dtype, with_bias=True
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
            h = h + _dir_contrib(self.layers_dir[0], pe_dir, HIDDEN, structure, dtype)
        x = torch.relu(h)
        for i in range(1, 3):
            x = torch.relu(linear(self.layers_dir[i], x, dtype))
        return torch.cat([linear(self.fc_rgb, x, dtype), alpha], dim=-1)


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
    "VeryTinyNeRFModel": VeryTinyNeRFModel,
    "MultiHeadNeRFModel": MultiHeadNeRFModel,
    "ReplicateNeRFModel": ReplicateNeRFModel,
    "PaperNeRFModel": PaperNeRFModel,
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
    cls = MODELS[model_cfg.type]
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
