"""Load an exported artifact directory (counterpart of
``blind_image_denoising_tpu/inference/export.py`` ``load_exported_model``).

An artifact is ``pipeline.json`` (the as-run config) + ``params.msgpack``
(flax-serialized variables: params, and ``batch_stats`` for BatchNorm
models) + optionally ``blend.json`` and ``quant.msgpack`` (int8 input
scales). The port reads the same files the JAX package writes; only
loading is ported. A ``"model": {"type": "unet_laplacian_v56"}`` config
builds ``models/unet_laplacian_v56.py``; every other config builds the
hydra of ``models/hydra.py``.
"""

import logging
from pathlib import Path
from typing import Optional, Union

import torch

from ..config import load_config
from ..models.hydra import model_builder
from ..models.unet_laplacian_v56 import UnetLaplacianV56
from ..weights import load_msgpack
from .denoiser import Denoiser, resolve_device

PARAMS_FILE = "params.msgpack"
CONFIG_FILE = "pipeline.json"
QUANT_FILE = "quant.msgpack"

logger = logging.getLogger("blind_image_denoising_torch")


def resolve_compute_dtype(dtype, config: Optional[dict] = None):
    """Serving compute dtype: ``None`` honours the artifact's own
    ``tpu.compute_dtype`` (the dtype it was trained in); strings
    "bfloat16"/"bf16"/"float32"/"f32"/"fp32" or torch dtypes override.
    Returns ``torch.bfloat16``, or None for float32."""
    if dtype is None and config is not None:
        dtype = config.get("tpu", {}).get("compute_dtype")
        if dtype is not None and str(dtype).lower() not in (
                "float32", "f32", "fp32"):
            logger.info(f"serving in the artifact's trained compute dtype "
                        f"[{dtype}] (pass dtype='float32' to override)")
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = dtype.lower()
        if name in ("bfloat16", "bf16"):
            return torch.bfloat16
        if name in ("float32", "f32", "fp32"):
            return None
        raise ValueError(f"unknown compute dtype [{dtype}]; use 'bfloat16' "
                         f"or 'float32'")
    if dtype == torch.bfloat16:
        return torch.bfloat16
    if dtype == torch.float32:
        return None
    raise ValueError(f"unsupported compute dtype [{dtype}]")


def _load_quant_scales(directory: Path, quant) -> Optional[dict]:
    """The artifact's int8 scales: required when ``quant=True``."""
    if not quant:
        return None
    path = directory / QUANT_FILE
    if not path.exists():
        raise ValueError(
            f"quant=True but [{path}] missing — re-export with "
            f"quantize=True (or --quantize on the export CLI)")
    return load_msgpack(path)


def _resolve_blend(directory: Path, blend):
    """``None`` = auto (serve the artifact's blend.json when it ships
    one); ``True`` requires it; ``False`` disables; a path/dict/BlendTable
    passes through."""
    if blend is False:
        return None
    from .blend import BLEND_FILE, BlendTable
    if blend is None or blend is True:
        path = directory / BLEND_FILE
        if not path.exists():
            if blend is True:
                raise ValueError(f"blend=True but [{path}] missing")
            return None
        if blend is None:
            logger.info(f"serving the artifact's calibrated noise-adaptive "
                        f"blend [{path}] (pass blend=False for the raw "
                        f"model output)")
        return BlendTable.from_any(str(path))
    return BlendTable.from_any(blend)


def load_exported_model(directory: Union[str, Path],
                        cast_to_uint8: bool = True,
                        quant: bool = False,
                        tta: bool = False,
                        dtype=None,
                        blend=None,
                        device=None) -> Denoiser:
    """Load an artifact directory into a ready :class:`Denoiser` on
    ``device`` (default: the card). ``quant=True`` serves the int8 path
    with the artifact's ``quant.msgpack`` scales and forces the float32
    compute dtype, since the calibration measured float32 activations.
    ``tta``: the dihedral self-ensemble (``True``/8, 4 or 2 members)."""
    dev = resolve_device(device)
    directory = Path(str(directory))
    config = load_config(str(directory / CONFIG_FILE))
    quant_scales = _load_quant_scales(directory, quant)
    blend_table = _resolve_blend(directory, blend)
    compute_dtype = None if quant else resolve_compute_dtype(dtype, config)
    if config.get("model", {}).get("type") == "unet_laplacian_v56":
        model = UnetLaplacianV56(dtype=compute_dtype)
    else:
        model = model_builder(config["model"], dtype=compute_dtype).hydra
    variables = load_msgpack(directory / PARAMS_FILE)
    if "params" not in variables:
        variables = {"params": variables}
    if quant_scales is not None:
        variables = dict(variables, quant=quant_scales)
    return Denoiser(model, variables, cast_to_uint8=cast_to_uint8,
                    quant=quant, tta=tta, blend=blend_table, device=dev)
