"""Feature flags that the reference hardcodes in Python, lifted into config.

The reference buries 8 training flags (`train_transformed_rays.py:128-137`)
and 6+1 eval flags (`eval_transformed_rays.py:374-380,420`) as module-level
Python constants.  Here they are first-class, optional config keys with the
reference's defaults, read from `cfg.experiment.flags.*` / `cfg.eval.*` when
present so that unmodified reference YAMLs keep the reference behavior.

Copied unchanged from `nerface_tpu/config/flags.py` (the PyTorch port never
imports the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FeatureFlags:
    """Training-time flags (defaults = reference `train_transformed_rays.py:128-137`)."""

    train_background: bool = False
    supervised_train_background: bool = False
    blur_background: bool = False
    train_latent_codes: bool = True
    disable_expressions: bool = False
    disable_latent_codes: bool = False
    fixed_background: bool = True
    regularize_latent_codes: bool = True

    def __post_init__(self):
        # Reference semantics: supervised bg training requires bg training
        # (`train_transformed_rays.py:140`).
        self.supervised_train_background = (
            self.train_background and self.supervised_train_background
        )

    @classmethod
    def from_cfg(cls, cfg) -> "FeatureFlags":
        """Read optional `experiment.flags` keys; absent keys keep defaults."""
        kwargs = {}
        try:
            flags_node = cfg.experiment.flags
        except (AttributeError, KeyError):
            return cls()
        for f in dataclasses.fields(cls):
            if f.name in flags_node:
                kwargs[f.name] = bool(flags_node[f.name])
        return cls(**kwargs)


@dataclasses.dataclass
class EvalFlags:
    """Eval-time ablation switches (defaults = reference `eval_transformed_rays.py:374-380`).

    `ablate` in the released script is hardcoded to 'view_dir'
    (`eval_transformed_rays.py:420`); a faithful rebuild exposes it as an
    off-by-default option (see SURVEY.md §2.4).
    """

    no_background: bool = False
    no_expressions: bool = False
    no_lcode: bool = False
    nerf: bool = False
    frontalize: bool = False
    interpolate_mouth: bool = False
    ablate: Optional[str] = None  # one of None|'expression'|'latent_code'|'view_dir'
    replace_background: bool = True
    fix_latent_code_index: bool = True  # reference pins idx_map[10,1] (:444)

    def __post_init__(self):
        if self.nerf:
            # `eval_transformed_rays.py:382-385`
            self.no_background = True
            self.no_expressions = True
            self.no_lcode = True

    @classmethod
    def from_cfg(cls, cfg) -> "EvalFlags":
        kwargs = {}
        try:
            node = cfg.eval
        except (AttributeError, KeyError):
            return cls()
        for f in dataclasses.fields(cls):
            if f.name in node:
                kwargs[f.name] = node[f.name]
        return cls(**kwargs)
