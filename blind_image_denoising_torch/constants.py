"""Framework-wide default constants (the serving path's subset of
``blind_image_denoising_tpu/constants.py``)."""

DEFAULT_EPSILON = 1e-3
DEFAULT_LN_EPSILON = 1e-3
