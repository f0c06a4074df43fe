"""blind_image_denoising_torch — the PyTorch/CUDA port of
``blind_image_denoising_tpu`` for NVIDIA Hopper (H100).

The port serves the JAX package's exported artifacts (``pipeline.json``
+ ``params.msgpack`` + ``blend.json``) with the same numerics, and runs
the JAX package's TPU kernels as hand-written CUDA kernels
(``csrc/``). It imports torch and numpy only — no JAX, flax, msgpack or
``blind_image_denoising_tpu`` module, and ``tensorstore``, ``h5py`` or
``tensorflow`` only on the format paths that need them — and reads the
JAX package's packaged artifacts by path.

    import blind_image_denoising_torch as bidt
    den = bidt.load_model("unet_laplacian_v6_tpu_scratch")   # on the card
    out = den(uint8_image)     # [H, W, 3] or [B, H, W, 3] uint8 in and out

The ``Denoiser`` has the JAX package's signature and options (``pad_mode``,
``tile_rows``, ``tta``, ``blend``, ``float_forward``, ``dispatch``), and
``serving.BatchingDenoiser`` / ``evaluate.noise_sweep`` run over it.
Every packaged artifact serves: the flagship, ``resnet_depthwise_scratch``
and ``unet_laplacian_v56_highnoise`` (also int8, ``quant=True``).

Training: ``train_loop(config, checkpoint_directory)`` (or ``python -m
blind_image_denoising_torch.train``) over the JAX package's configs
(``configs``: its packaged configs as ``(filename, config dict)`` pairs,
read in place; ``CONFIGS_DICT``: name → config dict), with images
decoded by ``load_image``; the builders under it
(``blind_image_denoising_torch.training``) are the JAX package's.
``export_model(config, checkpoint_directory, output_directory)`` (or
``python -m blind_image_denoising_torch.export``) turns a run into an
artifact directory that this package's and the JAX package's
``load_model`` both serve; ``python -m blind_image_denoising_torch.build``
writes a seeded model's params and its structure.
``build_pyramid_model`` / ``build_inverse_pyramid_model`` build the
Gaussian and Laplacian pyramids of a config (``ops/pyramid.py``).

The formats tied to JAX and TensorFlow load too: ``load_model`` serves a
reference-style directory (``model_hydra.keras``, a SavedModel on the
CPU, ``denoiser_model.tflite`` through the port's own executor), the
checkpoint manager reads a JAX run's Orbax steps, and ``export_model(...,
to_torch_export=True)`` writes a ``torch.export`` program
(``denoiser.pt2``) in the place of JAX's StableHLO.

Several processes (``parallel``): a mesh over the ranks of a
``torch.distributed`` process group, the data-parallel train step and
``train_loop`` (one ``python -m blind_image_denoising_torch.train ...
--coordinator-address HOST:PORT --num-processes N --process-id R`` per
rank) and spatially sharded serving (``Denoiser(mesh=...,
spatial_margin=...)``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import logging as _logging
import os as _os
import pathlib as _pathlib

from . import ops
from .config import input_shape_fixer, load_config, save_config
from .ops.pyramid import (
    build_inverse_pyramid_fn as build_inverse_pyramid_model,
    build_pyramid_fn as build_pyramid_model)

logger = _logging.getLogger("blind_image_denoising_torch")

__version__ = "0.1.0"

# the JAX package's packaged artifacts and configs, read in place
_jax_pkg_dir = (_pathlib.Path(__file__).resolve().parent.parent
                / "blind_image_denoising_tpu")
_pretrained_dir = _jax_pkg_dir / "pretrained"
configs = [(p.name, load_config(str(p)))
           for p in sorted((_jax_pkg_dir / "configs").glob("*.json"))]
CONFIGS_DICT = {_os.path.splitext(name)[0]: cfg for name, cfg in configs}

# `models` is also the name of the subpackage: import it first, then
# rebind the attribute, so `bidt.models` is the registry dict while
# `blind_image_denoising_torch.models.hydra` still resolves through
# sys.modules
from . import models as _models_subpackage  # noqa: F401,E402

# the files that make a directory an artifact: the port's native one, and
# the reference formats
_ARTIFACT_FILES = ("params.msgpack", "model_hydra.keras",
                   "denoiser_model.tflite", "saved_model.pb",
                   "denoiser/saved_model.pb")


def _find_models() -> dict:
    """The registry: every artifact directory under the packaged
    ``pretrained/`` and under the roots of ``BID_TPU_PRETRAINED_PATH``
    (colon-separated), first name wins, as in the JAX package."""
    found = {}
    roots = [_pretrained_dir] + [
        _pathlib.Path(p) for p in
        _os.environ.get("BID_TPU_PRETRAINED_PATH", "").split(":") if p]
    for root in roots:
        if not root.is_dir():
            continue
        for d in sorted(root.iterdir()):
            if d.is_dir() and d.name not in found and any(
                    (d / f).is_file() for f in _ARTIFACT_FILES):
                found[d.name] = {"directory": str(d),
                                 "configuration": str(d / "pipeline.json")}
    return found


models = _find_models()


def load_model(name_or_path, quant: bool = False, tta=False, dtype=None,
               blend=None, device=None):
    """Load a packaged denoiser by registry name, or an artifact directory,
    in JAX's order: a native artifact (``params.msgpack`` +
    ``pipeline.json``), then a reference-style one — ``model_hydra.keras``
    by native import into the port's v5.6 model, then a SavedModel, then
    ``denoiser_model.tflite`` through the port's TFLite executor.

    ``quant=True`` serves the artifact's int8 path with its shipped
    ``quant.msgpack`` scales, in float32 (``ValueError`` when the
    artifact has none, as in JAX). ``dtype``: serving compute dtype;
    ``None`` honours the artifact's ``tpu.compute_dtype`` (bfloat16 for
    the flagship and the resnet; float32 for
    ``unet_laplacian_v56_highnoise`` and the ``.keras`` import, which
    name none). ``blend``: ``None`` serves the artifact's ``blend.json``
    when it ships one, ``False`` disables it. ``device``: ``None`` is the
    card (raises without one); pass ``"cpu"`` to run on the CPU.
    ``tta``: the dihedral self-ensemble, ``True``/``8`` members, ``4``
    (the flips) or ``2`` ({id, 180°}). ``tta``, ``blend`` and ``dtype``
    need a native graph (``params.msgpack`` or ``model_hydra.keras``) and
    raise JAX's errors otherwise.

    A ``.keras`` archive that cannot be read falls through to the TFLite
    graph, as in JAX (only an error of reading the archive). The
    SavedModel runs in TensorFlow on its own device, so it is served
    only with ``device="cpu"``; on the card it raises ``ValueError``.
    The SavedModel and TFLite branches take uint8 (floats are rounded
    and clipped) and return uint8: the TFLite graph's float output is
    rounded and clipped too, where JAX hands it back as it is. A missing
    format library (``h5py``, ``tensorflow``) raises ``ImportError``."""
    from .inference.denoiser import Denoiser, as_uint8
    from .inference.export import (_resolve_blend, load_exported_model,
                                   resolve_compute_dtype, resolve_device)

    dev = resolve_device(device)
    path = (models[name_or_path]["directory"] if name_or_path in models
            else str(name_or_path))
    if not _os.path.isdir(path):
        raise ValueError(
            f"[{name_or_path}] is neither a known pretrained model "
            f"({sorted(models)}) nor an artifact directory")
    if _os.path.isfile(_os.path.join(path, "params.msgpack")):
        return load_exported_model(path, quant=quant, tta=tta, dtype=dtype,
                                   blend=blend, device=device)
    if quant:
        raise ValueError(
            f"quant=True needs a native exported artifact with "
            f"quant.msgpack; [{path}] has no params.msgpack")
    keras_path = _os.path.join(path, "model_hydra.keras")
    if _os.path.isfile(keras_path):
        # the reference's pretrained weights in the port's own v5.6 model
        # (dtype None = float32: a reference import names no compute
        # dtype, and parity with the reference artifact is its contract)
        from .inference.import_v56 import (KerasImportError,
                                           build_pretrained_v56)
        try:
            model, variables = build_pretrained_v56(
                keras_path, dtype=resolve_compute_dtype(dtype))
        except KerasImportError as e:
            if tta:
                raise ValueError(
                    f"tta=True needs a native-graph artifact, and the "
                    f"import of [{keras_path}] failed: {e}") from e
            logger.warning(f"native .keras import failed ({e}); "
                           f"falling back to the TFLite graph")
        else:
            return Denoiser(model, variables, pad_mode="pow2", tta=tta,
                            blend=_resolve_blend(_pathlib.Path(path), blend),
                            device=dev)
    if tta:
        raise ValueError(
            f"tta=True needs a native-graph artifact (params.msgpack or "
            f"model_hydra.keras); [{path}] has neither")
    if blend:
        raise ValueError(
            f"blend needs a native-graph artifact (params.msgpack or "
            f"model_hydra.keras); [{path}] has neither")
    if resolve_compute_dtype(dtype) is not None:
        raise ValueError(
            f"dtype={dtype!r} needs a native-graph artifact "
            f"(params.msgpack or model_hydra.keras); [{path}] has "
            f"neither — the SavedModel/TFLite fallbacks execute the "
            f"artifact's own graph")
    from .inference.savedmodel import find_savedmodel
    sm_path = find_savedmodel(path)
    if sm_path is not None:
        if dev.type != "cpu":
            raise ValueError(
                f"[{sm_path}] is a SavedModel, which TensorFlow runs on its "
                f"own device and not on {dev}: pass device='cpu' to serve "
                f"it")
        from .inference.savedmodel import (SavedModelLoadError,
                                           load_savedmodel_denoiser)
        try:
            return load_savedmodel_denoiser(sm_path)
        except SavedModelLoadError as e:
            logger.warning(f"SavedModel load failed ({e}); falling back to "
                           f"the TFLite graph")
    tflite_path = _os.path.join(path, "denoiser_model.tflite")
    if _os.path.isfile(tflite_path):
        import numpy as _np
        from .inference.tflite import load_tflite_denoiser
        fn = load_tflite_denoiser(tflite_path, device=dev)

        def denoiser(image):
            x = _np.asarray(image)
            squeeze = x.ndim == 3
            y = as_uint8(fn(as_uint8(x[None] if squeeze else x)))
            return y[0] if squeeze else y

        return denoiser
    raise ValueError(f"no loadable artifact in [{path}]")


# alias, as in the JAX package: both load the same uint8 Denoiser
load_denoiser_model = load_model


def load_default_denoiser(device=None):
    """Load the first packaged pretrained denoiser (by name)."""
    if not models:
        raise ValueError("no pretrained models packaged")
    return load_model(sorted(models)[0], device=device)


# resolved on first access, so `import blind_image_denoising_torch` stays
# light
_LAZY_EXPORTS = {
    "model_builder": ("blind_image_denoising_torch.models.hydra",
                      "model_builder"),
    "schedule_builder": ("blind_image_denoising_torch.training.optimizer",
                         "schedule_builder"),
    "optimizer_builder": ("blind_image_denoising_torch.training.optimizer",
                          "optimizer_builder"),
    "train_loop": ("blind_image_denoising_torch.training.train_loop",
                   "train_loop"),
    "export_model": ("blind_image_denoising_torch.inference.export",
                     "export_model"),
    "load_image": ("blind_image_denoising_torch.data.file_operations",
                   "load_image"),
    "Multiplier": ("blind_image_denoising_torch.layers.multipliers",
                   "Multiplier"),
    "ChannelwiseMultiplier": ("blind_image_denoising_torch.layers."
                              "multipliers", "ChannelwiseMultiplier"),
}


def __getattr__(name):
    if name in _LAZY_EXPORTS:
        import importlib
        module, attr = _LAZY_EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["logger", "load_config", "save_config", "input_shape_fixer",
           "ops", "configs", "CONFIGS_DICT", "models", "load_model",
           "load_denoiser_model", "load_default_denoiser",
           "build_pyramid_model", "build_inverse_pyramid_model"] + sorted(
               _LAZY_EXPORTS)
