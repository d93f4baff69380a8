"""Train state, the train / eval steps, and the training loop (Trainer,
checkpoints, preemption)."""

from speech_decoding_tpu_torch.training.checkpoint import CheckpointManager
from speech_decoding_tpu_torch.training.preemption import PreemptionGuard
from speech_decoding_tpu_torch.training.state import TrainState, create_train_state
from speech_decoding_tpu_torch.training.steps import (
    make_chunked_eval,
    make_eval_step,
    make_train_forward_step,
    make_train_step,
    make_train_step_scan,
)
from speech_decoding_tpu_torch.training.trainer import Trainer

__all__ = [
    "CheckpointManager",
    "PreemptionGuard",
    "Trainer",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_train_step_scan",
    "make_train_forward_step",
    "make_eval_step",
    "make_chunked_eval",
]
