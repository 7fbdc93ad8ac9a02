from nerface_tpu_torch.config.cfgnode import CfgNode, load_config
from nerface_tpu_torch.config.flags import EvalFlags, FeatureFlags

__all__ = ["CfgNode", "load_config", "EvalFlags", "FeatureFlags"]
