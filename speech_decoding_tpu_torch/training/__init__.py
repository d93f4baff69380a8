"""Train state and the train / eval steps."""

from speech_decoding_tpu_torch.training.state import TrainState, create_train_state
from speech_decoding_tpu_torch.training.steps import (
    make_chunked_eval,
    make_eval_step,
    make_train_forward_step,
    make_train_step,
    make_train_step_scan,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_train_step_scan",
    "make_train_forward_step",
    "make_eval_step",
    "make_chunked_eval",
]
