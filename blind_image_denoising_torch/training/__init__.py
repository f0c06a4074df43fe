"""Training (counterpart of ``blind_image_denoising_tpu/training``): the
losses, the optimizer and its schedules, the train state, the train and
eval steps; checkpoints (``checkpoint``), metrics (``metrics``),
profiling (``profiling``) and the loop (``train_loop``) are modules of
their own."""

from .losses import loss_function_builder
from .optimizer import (deep_supervision_schedule_builder, optimizer_builder,
                        schedule_builder)
from .train_state import TrainState, create_train_state, param_count
from .train_step import build_eval_step, build_train_step, forward_loss
