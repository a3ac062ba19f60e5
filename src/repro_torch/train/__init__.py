from repro_torch.train.step import (StepConfig, TrainState,  # noqa: F401
                                    make_eval_step, make_train_step,
                                    train_state_init, train_state_shapes)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
