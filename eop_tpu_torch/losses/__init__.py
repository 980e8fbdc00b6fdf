from .iou_loss import bce_with_logits
from .loss_24p import (
    DWAState,
    Loss24PAux,
    Loss24PConfig,
    loss_24p,
    simota_assign_24p,
)
from .simota import Assignment, SimOTAConfig, simota_assign
from .yolox_loss import YoloxLossAux, YoloxLossConfig, yolox_losses

__all__ = [
    "Assignment", "DWAState", "Loss24PAux", "Loss24PConfig", "SimOTAConfig",
    "YoloxLossAux", "YoloxLossConfig", "bce_with_logits", "loss_24p",
    "simota_assign", "simota_assign_24p", "yolox_losses",
]
