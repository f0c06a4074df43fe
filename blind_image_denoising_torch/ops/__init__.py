"""Functional ops (counterpart of ``blind_image_denoising_tpu/ops``), on
NHWC tensors as in JAX. The kernel wrappers keep JAX's names beside the
port's own: ``corrupt_batch_pallas`` is ``pallas_noise.corrupt_noise``
(K3), ``laplacian_band_split_pallas`` is ``pallas_pyramid.band_split``
(K4) and ``laplacian_band_split_reference`` its plain version."""

from .normalize import (
    normalize,
    denormalize,
    clip_normalized,
    clip_unnormalized,
    global_normalization,
    local_normalization,
    highpass_filter,
    lowpass_filter,
    details,
)
from .padding import next_power_of_2, pad_to_power_of_2, remove_padding
from .resize import (
    avg_pool_same,
    avg_pool_valid,
    max_pool_same,
    upsample_2x_nearest,
    upsample_2x_bilinear,
    downsample_2x_stride,
    resize_bilinear,
)
from .gaussian import (gaussian_kernel_2d, depthwise_gaussian_kernel,
                       gaussian_blur)
from .pyramid import (
    PyramidType,
    gaussian_pyramid,
    inverse_gaussian_pyramid,
    laplacian_pyramid,
    inverse_laplacian_pyramid,
    build_pyramid_fn,
    build_inverse_pyramid_fn,
)
from .losses import mae_diff, mae, rmse_diff, rmse, gar_loss, improvement, psnr
from .ssim import ssim, ssim_loss
from .noise import (truncated_normal, corrupt_batch, corrupt_batch_fixed_std,
                    random_flips)
from .degradations import (
    rotate_batch,
    random_rotate_batch,
    random_blur,
    jpeg_artifacts,
    random_jpeg,
    quantize_batch,
    random_quantize,
    inpaint_dropout,
    degrade_batch,
)
from .pallas_noise import corrupt_noise as corrupt_batch_pallas
from .pallas_pyramid import (
    band_split as laplacian_band_split_pallas,
    band_split_plain as laplacian_band_split_reference,
)
from .multiscale import multiscale_targets
from . import regularizers
