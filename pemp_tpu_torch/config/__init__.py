from pemp_tpu_torch.config.defaults import (
    check_path,
    get_config,
    load_config,
    small,
    small_train,
    update_config,
    update_config_command,
    w32_512_train,
    w48_640,
)
from pemp_tpu_torch.config.node import ConfigNode

__all__ = ["ConfigNode", "check_path", "get_config", "load_config", "small", "small_train",
           "update_config", "update_config_command", "w32_512_train", "w48_640"]
