"""Training: losses, the optimizer, the train state and the train step
(counterpart of ``blind_image_denoising_tpu/training``; the loop, the
dataset and checkpoints are not ported yet, ROADMAP Queue 1 item 8)."""

from .losses import loss_function_builder
from .optimizer import optimizer_builder, schedule_builder
from .train_state import TrainState, create_train_state
from .train_step import build_train_step, forward_loss
