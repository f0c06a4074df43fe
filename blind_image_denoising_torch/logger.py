"""stdlib logger under the JAX package's name and format (counterpart of
``blind_image_denoising_tpu/logger.py``; reference custom_logger.py:7-14).
The ``parallel`` modules log through it."""

import logging

_FORMAT = "%(asctime)s %(levelname)-4s %(filename)s:%(funcName)s:%(lineno)s] %(message)s"

logging.basicConfig(level=logging.INFO, format=_FORMAT)
logger = logging.getLogger("bfcnn_tpu")
logger.setLevel(logging.INFO)
