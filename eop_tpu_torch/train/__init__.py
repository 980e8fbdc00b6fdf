from .steps import TrainState, create_train_state, make_train_step_24p

__all__ = ["TrainState", "create_train_state", "make_train_step_24p"]
