"""Post-training int8 calibration (counterpart of
``blind_image_denoising_tpu/inference/quantize.py``).

:func:`calibrate` runs representative images through the float model
under ``quant_mode("calibrate")``, keeps every conv site's input amax
(the maximum over batches) and returns the ``quant`` collection of
per-tensor input scales ``max(amax, 1e-12) / 127``, nested by flax
module path like ``quant.msgpack``, so ``weights.attach_quant_scales``
takes it, ``weights.save_msgpack`` writes it as JAX's export does
(``inference/export.export_model(quantize=True)``), and JAX's
``load_model(quant=True)`` accepts the file. The sites are every
``ConvBlock`` and the three convs of every ConvNext unit (``conv_1``,
``conv_2``, ``conv_3``), as in JAX::

    from blind_image_denoising_torch.inference.quantize import calibrate
    quant = calibrate(model, images)            # model: Hydra / v56
    attach_quant_scales(model, quant)
    den = Denoiser(model, quant=True, device=device)   # int8 serving
"""

import logging
from typing import Dict, Iterable, Union

import numpy as np
import torch

from ..images import load_evaluation_images
from ..ops.quant import INT8_MAX, quant_mode
from ..ops.resize import nchw

logger = logging.getLogger("blind_image_denoising_torch")


def calibrate(model: torch.nn.Module,
              images: Union[np.ndarray, Iterable[np.ndarray]],
              batch_size: int = 4, exclude: tuple = ()) -> Dict:
    """``images``: [N, H, W, C] float array in the model's value range
    (e.g. [0, 255]), or an iterable of such batches; include noisy
    samples over the deployment's noise levels. Runs on the model's
    device; returns the nested ``quant`` tree of float32 scales, each a
    0-d numpy array (the leaves JAX's ``quant.msgpack`` holds)."""
    if isinstance(images, np.ndarray):
        arr = np.asarray(images, np.float32)
        batches = [arr[i:i + batch_size]
                   for i in range(0, len(arr), batch_size)]
    else:
        batches = images
    ref = next(model.parameters())
    stats, n = {}, 0
    with torch.inference_mode(), quant_mode("calibrate", exclude=exclude,
                                            stats=stats):
        for batch in batches:
            x = torch.as_tensor(np.asarray(batch, np.float32),
                                device=ref.device)
            model(nchw(x))
            n += len(batch)
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    tree: Dict = {}
    for (path, site), a in stats.items():
        node = tree
        for part in filter(None, path.split("/")):
            node = node.setdefault(part, {})
        amax = np.maximum(np.float32(a.item()), np.float32(1e-12))
        node[f"{site}_scale"] = np.asarray(amax / np.float32(INT8_MAX),
                                           np.float32)
    logger.info(f"int8 calibration: {n} images -> input scales for "
                f"{len(stats)} conv sites")
    return tree


def default_calibration_images(noise_stds=(0.0, 10.0, 25.0, 50.0, 80.0),
                               size: int = 256, seed: int = 0) -> np.ndarray:
    """The packaged evaluation images at each noise level of
    ``noise_stds`` (rounded and clipped), [5·4, size, size, 3] float32."""
    base = np.asarray(load_evaluation_images(size), np.float32)
    rng = np.random.default_rng(seed)
    out = []
    for std in noise_stds:
        noisy = base + rng.normal(0.0, std, base.shape) if std > 0 else base
        out.append(np.clip(np.round(noisy), 0, 255))
    return np.concatenate(out, axis=0).astype(np.float32)
