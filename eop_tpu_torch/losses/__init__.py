from .iou_loss import bce_with_logits
from .loss_24p import (
    DWAState,
    Loss24PAux,
    Loss24PConfig,
    loss_24p,
    simota_assign_24p,
)
from .simota import Assignment, SimOTAConfig

__all__ = [
    "Assignment", "DWAState", "Loss24PAux", "Loss24PConfig", "SimOTAConfig",
    "bce_with_logits", "loss_24p", "simota_assign_24p",
]
