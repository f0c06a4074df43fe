"""Load an exported artifact directory (counterpart of
``blind_image_denoising_tpu/inference/export.py`` ``load_exported_model``).

An artifact is ``pipeline.json`` (the as-run config) + ``params.msgpack``
(flax-serialized variables) + optionally ``blend.json``. The port reads
the same files the JAX package writes; only loading is ported.
"""

import logging
from pathlib import Path
from typing import Optional, Union

import torch

from ..config import load_config
from ..models.hydra import model_builder
from ..weights import load_msgpack, params_from_flax
from .denoiser import Denoiser

PARAMS_FILE = "params.msgpack"
CONFIG_FILE = "pipeline.json"

logger = logging.getLogger("blind_image_denoising_torch")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises; the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


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
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    directory = Path(str(directory))
    config = load_config(str(directory / CONFIG_FILE))
    if config.get("model", {}).get("type") == "unet_laplacian_v56":
        raise NotImplementedError(
            "unet_laplacian_v56 artifacts are not ported yet (ROADMAP "
            "Queue 1 item 9)")
    blend_table = _resolve_blend(directory, blend)
    compute_dtype = resolve_compute_dtype(dtype, config)
    hydra = model_builder(config["model"], dtype=compute_dtype).hydra
    state = params_from_flax(load_msgpack(directory / PARAMS_FILE))
    hydra.load_state_dict(state, strict=True)
    return Denoiser(hydra, dev, cast_to_uint8=cast_to_uint8,
                    blend=blend_table, tta=tta, quant=quant)
