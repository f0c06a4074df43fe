"""Framework-wide default constants (the serving and training paths'
subset of ``blind_image_denoising_tpu/constants.py``)."""

DEFAULT_EPSILON = 1e-3
DEFAULT_BN_EPSILON = 1e-3
DEFAULT_LN_EPSILON = 1e-3
DEFAULT_BN_MOMENTUM = 0.995
DEFAULT_MULTIPLIER_L1 = 1.0
DEFAULT_CHANNELWISE_MULTIPLIER_L1 = 0.1

# metric names of the train step
MAE_LOSS_STR = "mae_loss"
MSE_LOSS_STR = "mse_loss"
SSIM_LOSS_STR = "ssim_loss"
TOTAL_LOSS_STR = "total_loss"
REGULARIZATION_LOSS_STR = "regularization_loss"
