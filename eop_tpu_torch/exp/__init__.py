from .base_exp import BaseExp
from .yolox_24p_base import Exp24P

# name -> attribute overrides of Exp24P.  "yolox_24p_s" equals
# load_eval/yolox_24p_eval.py (which imports eop_tpu, so the port cannot
# load the file itself).
PRESETS = {
    "yolox_24p_s": dict(depth=0.33, width=0.50, num_classes=80),
}


def get_exp(name: str = "yolox_24p_s") -> Exp24P:
    if name not in PRESETS:
        raise ValueError(f"unknown exp {name!r}; known: {sorted(PRESETS)}")
    exp = Exp24P()
    for k, v in PRESETS[name].items():
        setattr(exp, k, v)
    return exp
