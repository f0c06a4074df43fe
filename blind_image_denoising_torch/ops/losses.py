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


def mae_diff(error: torch.Tensor, hinge: float = 0.0,
             cutoff: float = 255.0) -> torch.Tensor:
    """Hinged, cut-off mean absolute value of an error batch."""
    d = _hinged_relu(torch.abs(error), hinge, cutoff)
    return torch.mean(torch.mean(d, dim=(1, 2, 3)))


def mae(original: torch.Tensor, prediction: torch.Tensor,
        hinge: float = 0.0, cutoff: float = 255.0) -> torch.Tensor:
    """Hinged, cut-off mean absolute error."""
    return mae_diff(original - prediction, hinge, cutoff)


def rmse_diff(error: torch.Tensor, hinge: float = 0.0,
              cutoff: float = 255.0 * 255.0) -> torch.Tensor:
    """Hinged root mean square of an error batch (hinge on the signed
    error)."""
    d = torch.square(_hinged_relu(error, hinge, cutoff))
    return torch.mean(torch.sqrt(torch.mean(d, dim=(1, 2, 3))
                                 + DEFAULT_EPSILON))


def rmse(original: torch.Tensor, prediction: torch.Tensor,
         hinge: float = 0.0, cutoff: float = 255.0 * 255.0) -> torch.Tensor:
    """Hinged root mean square error (hinge on the signed error)."""
    return rmse_diff(original - prediction, hinge, cutoff)


def gar_loss(x: torch.Tensor, alpha: float = 1.0,
             c: float = 1.0) -> torch.Tensor:
    """Barron's general and adaptive robust loss."""
    a_2 = abs(alpha - 2.0)
    return (a_2 / alpha) * (torch.pow(torch.square(x / c) / a_2 + 1.0,
                                      alpha / 2.0) - 1.0)


def improvement(original: torch.Tensor, noisy: torch.Tensor,
                denoised: torch.Tensor) -> torch.Tensor:
    """MAE(original, noisy) − MAE(original, denoised): positive when the
    denoiser helps."""
    return mae(original, noisy) - mae(original, denoised)


def psnr(original: torch.Tensor, prediction: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, the mean over the batch."""
    mse = torch.mean(torch.square(original - prediction), dim=(1, 2, 3))
    return torch.mean(20.0 * math.log10(max_val)
                      - 10.0 * torch.log10(mse + 1e-12))
