"""Training state and the optimizer.

Port of `nerface_tpu/train/state.py`, with the reference checkpoint's
logical schema (`train_transformed_rays.py:554-572`): the coarse and fine
`nn.Module`s, the (n_train, 32) latent-code table (a Parameter of zeros),
the background (a Parameter when trained, else a fixed tensor) and the
step. `build_optimizer` is `torch.optim.Adam` over the reference's
parameter order in its two param groups: coarse weights, fine weights and
the latent table, then the background slot, which holds the background
even when it is not trained (`train_transformed_rays.py:170-200`), so a
checkpoint's `optimizer_state_dict` loads in the reference, in the JAX
package (`import_torch_optimizer_state`) and here alike.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from nerface_tpu_torch.config.flags import FeatureFlags

LATENT_DIM = 32


@dataclasses.dataclass
class TrainState:
    model_coarse: nn.Module
    model_fine: Optional[nn.Module]
    latent_codes: Optional[nn.Parameter]  # (n_train, 32) when trained
    background: Optional[torch.Tensor]  # (H, W, 3): a Parameter when trained
    train_background: bool
    step: int = 0

    def ordered_params(self) -> List[torch.Tensor]:
        """The first param group in the reference's order: coarse and fine
        weights in registration order, then the latent table."""
        params = list(self.model_coarse.parameters())
        if self.model_fine is not None:
            params += list(self.model_fine.parameters())
        if self.latent_codes is not None:
            params.append(self.latent_codes)
        return params

    def background_slot(self) -> torch.Tensor:
        """The second param group's tensor: the background, or a stand-in
        when the run has none."""
        if self.background is not None:
            return self.background
        return torch.zeros(1, device=next(self.model_coarse.parameters()).device)


def create_train_state(
    model_coarse: nn.Module,
    model_fine: Optional[nn.Module],
    flags: FeatureFlags,
    n_train: int,
    background: Optional[np.ndarray] = None,
    device=None,
) -> TrainState:
    """Latent codes start at zeros(n_train, 32)
    (`train_transformed_rays.py:181-186`); a trainable background starts
    from `background` (the mean of the train frames upstream), a fixed one
    is the given image."""
    device = device or next(model_coarse.parameters()).device
    latent = None
    if flags.train_latent_codes and not flags.disable_latent_codes:
        latent = nn.Parameter(torch.zeros(n_train, LATENT_DIM, device=device))
    bg = None
    train_bg = bool(flags.train_background and background is not None)
    if background is not None and (flags.train_background or flags.fixed_background):
        t = torch.tensor(np.asarray(background, np.float32), device=device)
        bg = nn.Parameter(t) if train_bg else t
    return TrainState(model_coarse, model_fine, latent, bg, train_bg, 0)


def build_optimizer(cfg, state: TrainState) -> torch.optim.Adam:
    """Adam at cfg.optimizer.lr in the reference's two param groups. The
    train step sets the groups' LR after each step (train/schedule.py)."""
    if str(cfg.optimizer.type).lower() != "adam":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer.type!r} is not ported yet (the port trains with Adam)"
        )
    lr = float(cfg.optimizer.lr)
    return torch.optim.Adam(
        [{"params": state.ordered_params()}, {"params": [state.background_slot()]}], lr=lr
    )

