from .cfg import CfgNode
from .defaults import add_tpu_config, add_ubteacher_config, get_cfg

__all__ = ["CfgNode", "get_cfg", "add_ubteacher_config", "add_tpu_config"]
