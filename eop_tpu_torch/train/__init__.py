from .steps import (
    TrainState,
    create_train_state,
    make_train_step_24p,
    make_train_step_bbox,
)

__all__ = ["TrainState", "create_train_state", "make_train_step_24p",
           "make_train_step_bbox"]
