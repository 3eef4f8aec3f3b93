from dlwp_cs_tpu_torch.train.train_step import (
    Optimizer,
    TrainState,
    init_params,
    init_state,
    make_eval_step,
    make_loss_fn,
    make_optimizer,
    make_scanned_train_step,
    make_train_step,
    model_apply,
    params_of,
    value_and_grad,
)
from dlwp_cs_tpu_torch.train.trainer import EarlyStoppingMin, History, Trainer

__all__ = [
    "EarlyStoppingMin",
    "History",
    "Optimizer",
    "TrainState",
    "Trainer",
    "init_params",
    "init_state",
    "make_eval_step",
    "make_loss_fn",
    "make_optimizer",
    "make_scanned_train_step",
    "make_train_step",
    "model_apply",
    "params_of",
    "value_and_grad",
]
