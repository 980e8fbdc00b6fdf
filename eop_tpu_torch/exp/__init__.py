from .base_exp import BaseExp
from .build import PRESETS, get_exp
from .yolox_24p_base import Exp24P
from .yolox_base import Exp

__all__ = ["BaseExp", "Exp", "Exp24P", "PRESETS", "get_exp"]
