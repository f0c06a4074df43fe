"""blind_image_denoising_torch — the PyTorch/CUDA port of
``blind_image_denoising_tpu`` for NVIDIA Hopper (H100).

The port serves the JAX package's exported artifacts (``pipeline.json``
+ ``params.msgpack`` + ``blend.json``) with the same numerics, and runs
the JAX package's TPU kernels as hand-written CUDA kernels
(``csrc/``). It imports torch and numpy only — no JAX, flax, msgpack or
``blind_image_denoising_tpu`` module — and reads the JAX package's
packaged artifacts by path.

    import blind_image_denoising_torch as bidt
    den = bidt.load_model("unet_laplacian_v6_tpu_scratch")   # on the card
    out = den(uint8_image)     # [H, W, 3] or [B, H, W, 3] uint8 in and out

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import os as _os
import pathlib as _pathlib

from .config import input_shape_fixer, load_config

__version__ = "0.1.0"

# the JAX package's packaged artifacts, read in place
_pretrained_dir = (_pathlib.Path(__file__).resolve().parent.parent
                   / "blind_image_denoising_tpu" / "pretrained")

# `models` is also the name of the subpackage: import it first, then
# rebind the attribute, so `bidt.models` is the registry dict while
# `blind_image_denoising_torch.models.hydra` still resolves through
# sys.modules
from . import models as _models_subpackage  # noqa: F401,E402

models = {}
if _pretrained_dir.is_dir():
    for _d in sorted(_pretrained_dir.iterdir()):
        if _d.is_dir() and (_d / "params.msgpack").is_file():
            models[_d.name] = {"directory": str(_d),
                               "configuration": str(_d / "pipeline.json")}


def load_model(name_or_path, quant: bool = False, tta=False, dtype=None,
               blend=None, device=None):
    """Load a packaged denoiser by registry name, or an artifact directory.

    ``dtype``: serving compute dtype; ``None`` honours the artifact's
    ``tpu.compute_dtype`` (bfloat16 for the flagship). ``blend``: ``None``
    serves the artifact's ``blend.json`` when it ships one, ``False``
    disables it. ``device``: ``None`` is the card (raises without one);
    pass ``"cpu"`` to run on the CPU. ``quant`` and ``tta`` are not
    ported yet and raise."""
    from .inference.export import load_exported_model, resolve_device

    resolve_device(device)
    path = (models[name_or_path]["directory"] if name_or_path in models
            else str(name_or_path))
    if not _os.path.isdir(path):
        raise ValueError(
            f"[{name_or_path}] is neither a known pretrained model "
            f"({sorted(models)}) nor an artifact directory")
    if not _os.path.isfile(_os.path.join(path, "params.msgpack")):
        raise NotImplementedError(
            f"[{path}] has no params.msgpack; reference (.keras, TFLite, "
            f"SavedModel) artifacts are not ported (ROADMAP Queue 1 item 13)")
    return load_exported_model(path, quant=quant, tta=tta, dtype=dtype,
                               blend=blend, device=device)


__all__ = ["load_config", "input_shape_fixer", "models", "load_model"]
