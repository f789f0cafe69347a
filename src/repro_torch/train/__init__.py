"""The decoder-layer executor, the loss and the single-device train step."""

from .loss import cross_entropy, top1_accuracy
from .step import Hyper, TrainState, init_train_state, make_loss_fn, make_train_step

__all__ = ["cross_entropy", "top1_accuracy", "Hyper", "TrainState",
           "init_train_state", "make_loss_fn", "make_train_step"]
