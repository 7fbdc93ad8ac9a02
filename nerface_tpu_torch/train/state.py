"""Training state and the optimizer.

Port of `nerface_tpu/train/state.py`, with the reference checkpoint's
logical schema (`train_transformed_rays.py:554-572`): the coarse and fine
`nn.Module`s, the (n_train, 32) latent-code table (a Parameter of zeros),
the background (a Parameter when trained, else a fixed tensor) and the
step. `build_optimizer` builds the configured optimizer (Adam unless the
config names another) over the reference's parameter order in its two
param groups: coarse weights, fine weights and the latent table, then the
background slot, which holds the background even when it is not trained
(`train_transformed_rays.py:170-200`), so a checkpoint's
`optimizer_state_dict` loads in the reference, in the JAX package
(`import_torch_optimizer_state`) and here alike.
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


OPTIMIZERS = ("adam", "flat_adam", "adamw", "sgd", "rmsprop")


def build_optimizer(cfg, state: TrainState) -> torch.optim.Optimizer:
    """The optimizer `cfg.optimizer.type` names, over the reference's two
    param groups, as the JAX package's optax twin at optax's defaults
    (`nerface_tpu/train/state.py:34-60`): adam and flat_adam (whose one flat
    buffer is a layout choice, not other math) are `torch.optim.Adam`,
    adamw `torch.optim.AdamW` with optax's weight decay 1e-4, sgd and
    rmsprop train/optim.py's.

    The LR is one 0-d f32 tensor on the parameters' device, shared by both
    groups, which the train step writes after each step (train/schedule.py);
    on the card Adam and AdamW keep their step counts there too
    (`capturable=True`). So a step reads nothing back to the host and can be
    captured in a CUDA graph (train/window.py), and the step-at-a-time path
    runs the very same configuration."""
    from nerface_tpu_torch.train import optim

    kind = str(cfg.optimizer.type).lower()
    if kind not in OPTIMIZERS:
        raise ValueError(f"unsupported optimizer type: {cfg.optimizer.type} (one of {OPTIMIZERS})")
    dev = next(state.model_coarse.parameters()).device
    lr = torch.tensor(float(cfg.optimizer.lr), dtype=torch.float32, device=dev)
    groups = [{"params": state.ordered_params()}, {"params": [state.background_slot()]}]
    capturable = dev.type == "cuda"
    if kind in ("adam", "flat_adam"):
        return torch.optim.Adam(groups, lr=lr, capturable=capturable)
    if kind == "adamw":
        return torch.optim.AdamW(groups, lr=lr, weight_decay=1e-4, capturable=capturable)
    if kind == "sgd":
        return optim.SGD(groups, lr=lr)
    return optim.RMSprop(groups, lr=lr)


def set_lr(optimizer: torch.optim.Optimizer, lr: torch.Tensor) -> None:
    """Write the 0-d tensor `lr` into the param groups' LR tensor in place
    (`build_optimizer`'s), so a captured step sees it."""
    for group in optimizer.param_groups:
        group["lr"].copy_(lr)


def conform_optimizer_state(optimizer: torch.optim.Optimizer, lr, capturable) -> None:
    """After `load_state_dict` (which takes the saved groups' LR and flags)
    or a hand-written state: put back the optimizer's LR tensor `lr` and
    the `capturable` flags it was built with (one a group), and move each
    step count to its parameter's device where the group is capturable."""
    for group, cap in zip(optimizer.param_groups, capturable):
        group["lr"] = lr
        if cap is None:
            continue
        group["capturable"] = cap
        for p in group["params"]:
            st = optimizer.state.get(p)
            if cap and st and isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
