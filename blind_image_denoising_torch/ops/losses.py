"""Denoising loss primitives (counterpart of
``blind_image_denoising_tpu/ops/losses.py``), with the reference's
quirks kept: the MAE hinge zeroes |error| below the hinge (it does not
shift it) and clamps it at the cutoff; the RMSE hinge acts on the
signed error, so only positive residuals count. Inputs are
[B, H, W, C] float32; the means run over each sample, then the batch.
"""

import math

import torch

from ..constants import DEFAULT_EPSILON


def _hinged_relu(x: torch.Tensor, hinge: float,
                 cutoff: float) -> torch.Tensor:
    """``tf.keras.activations.relu(x, threshold=hinge, max_value=cutoff)``."""
    y = torch.where(x > hinge, x, torch.zeros_like(x))
    return torch.clamp(y, max=cutoff)


def mae(original: torch.Tensor, prediction: torch.Tensor,
        hinge: float = 0.0, cutoff: float = 255.0) -> torch.Tensor:
    """Hinged, cut-off mean absolute error."""
    d = _hinged_relu(torch.abs(original - prediction), hinge, cutoff)
    return torch.mean(torch.mean(d, dim=(1, 2, 3)))


def rmse(original: torch.Tensor, prediction: torch.Tensor,
         hinge: float = 0.0, cutoff: float = 255.0 * 255.0) -> torch.Tensor:
    """Hinged root mean square error (hinge on the signed error)."""
    d = torch.square(_hinged_relu(original - prediction, hinge, cutoff))
    return torch.mean(torch.sqrt(torch.mean(d, dim=(1, 2, 3))
                                 + DEFAULT_EPSILON))


def psnr(original: torch.Tensor, prediction: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, the mean over the batch."""
    mse = torch.mean(torch.square(original - prediction), dim=(1, 2, 3))
    return torch.mean(20.0 * math.log10(max_val)
                      - 10.0 * torch.log10(mse + 1e-12))
