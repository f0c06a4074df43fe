"""Config-driven loss functions (counterpart of
``blind_image_denoising_tpu/training/losses.py`` ``loss_function_builder``).

* ``denoiser`` — per-scale supervised loss on NHWC float32 batches:
  hinged MAE × mae_multiplier + hinged RMSE × mse_multiplier +
  (1 − SSIM(filter_size=7)) × ssim_multiplier, plus the un-hinged MAE
  and RMSE, always reported. A multiplier ≤ 0 disables its term.
* ``model`` — the regularization sum
  (``ops/regularizers.regularization_loss``) × the ``regularization``
  multiplier.
"""

from typing import Callable, Dict

import torch

from ..constants import (MAE_LOSS_STR, MSE_LOSS_STR, REGULARIZATION_LOSS_STR,
                         SSIM_LOSS_STR, TOTAL_LOSS_STR)
from ..ops.losses import mae, rmse
from ..ops.ssim import ssim


def loss_function_builder(config: Dict) -> Dict[str, Callable]:
    hinge = config.get("hinge", 0.0)
    cutoff = config.get("cutoff", 255.0)
    mae_multiplier = config.get("mae_multiplier", 1.0)
    mse_multiplier = config.get("mse_multiplier", 0.0)
    ssim_multiplier = config.get("ssim_multiplier", 1.0)
    regularization_multiplier = config.get("regularization", 1.0)

    def model_loss(regularization: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {REGULARIZATION_LOSS_STR: regularization,
                TOTAL_LOSS_STR: regularization * regularization_multiplier}

    def denoiser_loss(gt_batch: torch.Tensor,
                      predicted_batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        mae_actual = mae(gt_batch, predicted_batch, hinge=0.0, cutoff=255.0)
        mse_actual = rmse(gt_batch, predicted_batch, hinge=0.0,
                          cutoff=255.0 * 255.0)
        zero = torch.zeros((), device=gt_batch.device)
        total, ssim_term = zero, zero
        if mae_multiplier > 0.0:
            total = total + mae_multiplier * mae(
                gt_batch, predicted_batch, hinge=hinge, cutoff=cutoff)
        if mse_multiplier > 0.0:
            total = total + mse_multiplier * rmse(
                gt_batch, predicted_batch, hinge=hinge,
                cutoff=cutoff * cutoff)
        if ssim_multiplier > 0.0:
            ssim_term = 1.0 - torch.mean(ssim(
                gt_batch, predicted_batch, max_val=255.0, filter_size=7))
            total = total + ssim_multiplier * ssim_term
        return {TOTAL_LOSS_STR: total, MAE_LOSS_STR: mae_actual,
                MSE_LOSS_STR: mse_actual, SSIM_LOSS_STR: ssim_term}

    return {"model": model_loss, "denoiser": denoiser_loss}
