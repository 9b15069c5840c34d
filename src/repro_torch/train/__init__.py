"""Training: the train step and the fault-tolerant trainer loop."""
from .step import TrainStepConfig, init_train_state, make_train_step

__all__ = ["TrainStepConfig", "init_train_state", "make_train_step"]
