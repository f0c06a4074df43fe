"""Config-driven loss functions (counterpart of
``blind_image_denoising_tpu/training/losses.py`` ``loss_function_builder``).

* ``denoiser`` — per-scale supervised loss on NHWC float32 batches:
  hinged MAE × mae_multiplier + hinged RMSE × mse_multiplier +
  (1 − SSIM(filter_size=7)) × ssim_multiplier, plus the un-hinged MAE
  and RMSE, always reported. A multiplier ≤ 0 disables its term.
* ``model`` — the regularization sum
  (``ops/regularizers.regularization_loss``) × the ``regularization``
  multiplier.

Under a spatially sharded step the denoiser loss takes a
``parallel/spatial.LossShare`` and returns this spatial rank's share of
each term, so that the sum over the spatial ranks is the loss of the
whole crops: MAE is a per-sample sum over the owned rows over the
global pixel count; RMSE's per-sample sums of squares are summed over
the spatial ranks (a differentiable ``all_reduce``) before the square
root, and the first rank carries the result; SSIM sums its map's owned
rows over the global (H − 6)(W − 6)C, and the first rank adds the 1.
"""

from typing import Callable, Dict

import torch

from ..constants import (DEFAULT_EPSILON, MAE_LOSS_STR, MSE_LOSS_STR,
                         REGULARIZATION_LOSS_STR, SSIM_LOSS_STR,
                         TOTAL_LOSS_STR)
from ..ops.losses import _hinged_relu, mae, rmse
from ..ops.ssim import ssim, ssim_map
from ..parallel.mesh import all_reduce_sum


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
                      predicted_batch: torch.Tensor,
                      share=None) -> Dict[str, torch.Tensor]:
        if share is not None:
            return _shared_denoiser_loss(gt_batch, predicted_batch, share)
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

    def _shared_denoiser_loss(gt_batch, predicted_batch, share):
        err = (gt_batch - predicted_batch).narrow(1, 0, share.rows)
        pixels = float(share.height * err.shape[2] * err.shape[3])
        first = 1.0 if share.first else 0.0

        def mae_share(h, cut):
            d = _hinged_relu(torch.abs(err), h, cut)
            return torch.mean(d.sum(dim=(1, 2, 3)) / pixels)

        def rmse_share(h, cut):
            d = torch.square(_hinged_relu(err, h, cut))
            sums = all_reduce_sum(d.sum(dim=(1, 2, 3)) / pixels, share.group)
            return torch.mean(torch.sqrt(sums + DEFAULT_EPSILON)) * first

        zero = torch.zeros((), device=gt_batch.device)
        total, ssim_term = zero, zero
        if mae_multiplier > 0.0:
            total = total + mae_multiplier * mae_share(hinge, cutoff)
        if mse_multiplier > 0.0:
            total = total + mse_multiplier * rmse_share(hinge,
                                                        cutoff * cutoff)
        if ssim_multiplier > 0.0:
            smap = ssim_map(gt_batch, predicted_batch, max_val=255.0,
                            filter_size=7)
            window = float((share.height - 6) * smap.shape[2]
                           * smap.shape[3])
            ssim_term = first - torch.mean(smap.sum(dim=(1, 2, 3)) / window)
            total = total + ssim_multiplier * ssim_term
        return {TOTAL_LOSS_STR: total,
                MAE_LOSS_STR: mae_share(0.0, 255.0),
                MSE_LOSS_STR: rmse_share(0.0, 255.0 * 255.0),
                SSIM_LOSS_STR: ssim_term}

    return {"model": model_loss, "denoiser": denoiser_loss}
