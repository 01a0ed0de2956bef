"""Config loading and the dataset class tables."""

from .config import (Config, get_cfg, init_cfg,  # noqa: F401
                     print_cfg, save_cfg, update_cfg)
from .constant import get_classes_by_name  # noqa: F401
