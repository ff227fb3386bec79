from pemp_tpu_torch.config.defaults import (
    ABLATIONS,
    PRESETS,
    UPPER_BOUNDS,
    ablation,
    check_path,
    get_config,
    hg_512,
    load_config,
    model_81_1_2,
    small,
    small_81_1_2,
    small_hg,
    small_train,
    update_config,
    update_config_command,
    upper_bound,
    w32_512,
    w32_512_train,
    w48_640,
)
from pemp_tpu_torch.config.node import ConfigNode

__all__ = ["ABLATIONS", "PRESETS", "UPPER_BOUNDS", "ConfigNode", "ablation", "check_path",
           "get_config", "hg_512", "load_config", "model_81_1_2", "small", "small_81_1_2",
           "small_hg", "small_train", "update_config", "update_config_command", "upper_bound",
           "w32_512", "w32_512_train", "w48_640"]
