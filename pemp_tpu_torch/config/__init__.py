from pemp_tpu_torch.config.defaults import get_config, small, update_config, w48_640
from pemp_tpu_torch.config.node import ConfigNode

__all__ = ["ConfigNode", "get_config", "small", "update_config", "w48_640"]
