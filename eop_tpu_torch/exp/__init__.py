from .base_exp import BaseExp
from .build import PRESETS, get_exp
from .yolox_24p_base import Exp24P

__all__ = ["BaseExp", "Exp24P", "PRESETS", "get_exp"]
