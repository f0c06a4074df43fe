"""TensorFlow SavedModel serving (counterpart of
``blind_image_denoising_tpu/inference/savedmodel.py``).

A reference-style artifact directory may hold a SavedModel — the
reference's ``export_model.py`` output, a ``DenoiserModule`` with a uint8
``[1, None, None, C]`` serving signature, or JAX's
``save_denoiser_savedmodel`` output (``[None, None, None, C]``). As in
JAX, TensorFlow loads and runs the graph; ``tensorflow`` is imported on
this path only, and a missing one raises ``ImportError``.

TensorFlow runs the graph on its own device, not on the card through the
port, so ``load_model`` takes this branch only with ``device="cpu"`` and
raises on the default device (``__init__.py``).

Writing a SavedModel is not ported (:func:`save_denoiser_savedmodel`
raises): JAX converts its forward with ``jax2tf``, and no converter from
PyTorch to TensorFlow is installed (``ai_edge_torch`` and ``onnx`` do
not import).
"""

import logging
import os
from typing import Callable, Optional

import numpy as np

from .denoiser import as_uint8

logger = logging.getLogger("blind_image_denoising_torch")


class SavedModelLoadError(ValueError):
    """TensorFlow could not load the SavedModel."""


def find_savedmodel(path: str) -> Optional[str]:
    """The SavedModel directory of a reference-style artifact directory:
    the directory itself or its ``denoiser/`` child."""
    for cand in (path, os.path.join(path, "denoiser")):
        if os.path.isfile(os.path.join(cand, "saved_model.pb")):
            return cand
    return None


def _import_tensorflow():
    try:
        import tensorflow
    except ImportError as e:
        raise ImportError("serving a SavedModel needs the 'tensorflow' "
                          "package, which runs its graph") from e
    return tensorflow


def load_savedmodel_denoiser(path: str) -> Callable:
    """A reference-style SavedModel → an any-size uint8 → uint8 numpy
    callable ([H, W, C] or [B, H, W, C]). A signature with a fixed batch
    of 1 is fed image by image. A directory TensorFlow cannot load
    raises :class:`SavedModelLoadError`."""
    tf = _import_tensorflow()
    from google.protobuf.message import DecodeError
    try:
        m = tf.saved_model.load(path)
    except (OSError, ValueError, DecodeError, tf.errors.OpError) as e:
        raise SavedModelLoadError(f"cannot load the SavedModel [{path}]: "
                                  f"{e}") from e
    sig = None
    if getattr(m, "signatures", None) and "serving_default" in m.signatures:
        sig = m.signatures["serving_default"]
    batch_fixed = None
    if sig is not None:
        specs = [s for s in tf.nest.flatten(sig.structured_input_signature,
                                            expand_composites=True)
                 if isinstance(s, tf.TensorSpec)]
        if len(specs) == 1 and specs[0].shape.rank == 4:
            batch_fixed = specs[0].shape[0]       # None when polymorphic

    def call(x):
        if sig is None:
            return m(x)
        out = sig(tf.constant(x))
        return next(iter(out.values())) if isinstance(out, dict) else out

    logger.info(f"loaded SavedModel from {path}"
                + (" (serving_default)" if sig is not None else "")
                + (f" (fixed batch {batch_fixed})"
                   if batch_fixed is not None else ""))

    def denoiser(image: np.ndarray) -> np.ndarray:
        x = np.asarray(image)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        x = as_uint8(x)
        if batch_fixed is not None and x.shape[0] != batch_fixed:
            if batch_fixed != 1:
                raise ValueError(
                    f"SavedModel signature has fixed batch {batch_fixed}; "
                    f"got batch {x.shape[0]}")
            y = np.concatenate([np.asarray(call(x[i:i + 1]))
                                for i in range(x.shape[0])], axis=0)
        else:
            y = np.asarray(call(x))
        y = as_uint8(y)
        return y[0] if squeeze else y

    return denoiser


def save_denoiser_savedmodel(model, variables, directory: str,
                             channels: int = 3) -> str:
    raise NotImplementedError(
        "writing a SavedModel is not available: JAX converts its forward "
        "with jax2tf, and no converter from PyTorch to TensorFlow is "
        "installed (ai_edge_torch, onnx)")
