"""Export and load artifact directories (counterpart of
``blind_image_denoising_tpu/inference/export.py``).

An artifact is ``pipeline.json`` (the as-run config) + ``params.msgpack``
(flax-serialized variables: params, and ``batch_stats`` for BatchNorm
models) + optionally ``blend.json`` and ``quant.msgpack`` (int8 input
scales). The port reads the files the JAX package writes and writes
files the JAX package reads:

* :func:`export_model` restores the latest checkpoint of a port run
  (``training/checkpoint.py``) and writes ``params.msgpack`` (the EMA
  weights when the run kept them, and the last iterate's batch
  statistics), ``pipeline.json`` and, with ``quantize=True``,
  ``quant.msgpack`` calibrated by ``inference/quantize.calibrate``;
* :func:`save_params_artifact` writes a directory from params and a
  config;
* :func:`load_exported_model` builds a ready :class:`Denoiser`. A
  ``"model": {"type": "unet_laplacian_v56"}`` config builds
  ``models/unet_laplacian_v56.py``; every other config builds the hydra
  of ``models/hydra.py``.

The serving artifact that needs no model code is a ``torch.export``
program, ``denoiser.pt2`` (:func:`serialize_torch_export`,
:func:`load_torch_export`; ``to_torch_export=True``), in the place of
JAX's ``denoiser.stablehlo``: ``to_stablehlo`` is False by default and
raises, naming ``to_torch_export``. JAX writes its TFLite and Keras
artifacts through ``jax2tf`` and TensorFlow; no converter from PyTorch
is installed, so ``to_tflite`` and ``to_keras`` raise
``NotImplementedError``. The port reads those formats
(``inference/tflite.py``, ``inference/keras_export.py``,
``inference/import_v56.py``, ``inference/savedmodel.py``).
"""

import io
import logging
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import load_config, save_config
from ..models.hydra import model_builder
from ..models.unet_laplacian_v56 import UnetLaplacianV56
from ..weights import flax_from_params, load_msgpack, save_msgpack
from .denoiser import Denoiser, resolve_device

PARAMS_FILE = "params.msgpack"
CONFIG_FILE = "pipeline.json"
QUANT_FILE = "quant.msgpack"
TORCH_EXPORT_FILE = "denoiser.pt2"

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


def _dim(v, default: int = 64) -> int:
    """A config spatial dim: "?" / None / <= 0 (the any-size convention)
    → ``default``."""
    if v in (None, "?"):
        return default
    v = int(v)
    return default if v <= 0 else v


def _no_converter(what: str):
    return NotImplementedError(
        f"{what} export is not available: JAX writes it through jax2tf and "
        f"TensorFlow's converters, and no converter from PyTorch is "
        f"installed (ai_edge_torch, onnx); the port writes params.msgpack, "
        f"pipeline.json, quant.msgpack and, with to_torch_export=True, "
        f"{TORCH_EXPORT_FILE}")


class _FinestScale(torch.nn.Module):
    """The finest-scale forward that an exported program holds: float32
    NHWC in the model's value range → the finest output, NHWC (JAX's
    ``model.apply(variables, x, train=False)[0]``)."""

    def __init__(self, hydra: torch.nn.Module):
        super().__init__()
        self.hydra = hydra

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.hydra(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)


def serialize_torch_export(model, reference_shape=(1, 256, 256, 3),
                           channels: int = 3,
                           pad_multiple: int = 64) -> Tuple[bytes, bool]:
    """``torch.export`` bytes of the hydra's finest-scale forward
    (:class:`_FinestScale`) on the device of its params, and whether the
    program is shape-polymorphic.

    The preferred program takes any batch and H, W that are multiples of
    ``pad_multiple`` (the Denoiser's padding contract), as JAX's
    ``serialize_stablehlo`` prefers; a model that does not trace so is
    exported at the static ``reference_shape`` instead, logged. The
    ConvNext units and the band split trace as the custom operators of
    ``ops/export_ops.py``, so the program launches K1 and K2."""
    from torch.export import Dim

    module = _FinestScale(model).eval().requires_grad_(False)
    device = next(model.parameters()).device
    static = tuple(reference_shape[:3]) + (channels,)
    # sizes of 1 would be specialized by the tracer: trace at 2 or more
    example = torch.zeros((max(static[0], 2),
                           max(static[1], 2 * pad_multiple),
                           max(static[2], 2 * pad_multiple), channels),
                          device=device)
    dims = ({0: Dim("b", min=1, max=4096),
             1: pad_multiple * Dim("h", min=1, max=1024),
             2: pad_multiple * Dim("w", min=1, max=1024)},)
    try:
        program = torch.export.export(module, (example,), dynamic_shapes=dims)
        dynamic = True
        logger.info(f"torch.export: shape-polymorphic (b, {pad_multiple}*h, "
                    f"{pad_multiple}*w, {channels})")
    except Exception as e:  # noqa: BLE001 - any trace failure: go static
        logger.info(f"torch.export: polymorphic trace unavailable "
                    f"({type(e).__name__}: {e}); exporting static {static}")
        program = torch.export.export(
            module, (torch.zeros(static, device=device),))
        dynamic = False
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue(), dynamic


def load_torch_export(directory: Union[str, Path], device=None):
    """The artifact's ``denoiser.pt2`` as a callable (float32 NHWC in the
    model's value range → the finest-scale output) on ``device``
    (default: the card): the consumption path that needs no model code.
    It imports ``ops/export_ops`` first, whose custom operators the
    program calls, and runs float32 without TF32
    (``ops/precision.exact_float32``). Raises when the file is absent."""
    from ..ops import export_ops  # noqa: F401 - registers the operators
    from ..ops.precision import exact_float32
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    path = Path(str(directory)) / TORCH_EXPORT_FILE
    if not path.exists():
        raise ValueError(f"no torch.export artifact at [{path}]; export "
                         f"with to_torch_export=True")
    program = move_to_device_pass(torch.export.load(str(path)), dev)
    module = program.module()

    def forward(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        with torch.no_grad(), exact_float32(dev.type == "cuda"):
            return module(x)

    return forward


def export_model(
        pipeline_config: Union[str, dict, Path],
        checkpoint_directory: Union[str, Path],
        output_directory: Union[str, Path],
        to_stablehlo: bool = False,
        to_tflite: bool = False,
        to_keras: bool = False,
        test_model: bool = False,
        reference_shape=(1, 256, 256, 3),
        quantize: bool = False,
        calibration_images=None,
        use_ema: bool = True,
        *, to_torch_export: bool = False, device=None) -> str:
    """Restore the latest checkpoint of ``checkpoint_directory`` into the
    float32 model of ``pipeline_config`` on ``device`` (default: the
    card) and write an artifact directory; returns its path.

    ``use_ema``: export the weight EMA when the run kept one (the weights
    training evaluated), else the last iterate; batch statistics are
    always the last iterate's. ``quantize``: also calibrate int8 input
    scales on ``calibration_images`` ([N, H, W, C] float in [0, 255];
    default: the packaged evaluation images at σ 0/10/25/50/80, at
    ``min(256, input size)``) and write ``quant.msgpack``.
    ``test_model``: load the artifact on ``device`` and denoise a 64×64
    probe. ``to_torch_export``: also write ``denoiser.pt2``
    (:func:`serialize_torch_export` of the float32 hydra, traced on
    ``device``; ``reference_shape`` is its static fallback).
    ``to_stablehlo`` raises and names ``to_torch_export``; ``to_tflite``
    and ``to_keras`` raise (module docstring)."""
    if to_stablehlo:
        raise NotImplementedError(
            "the port writes no StableHLO: its serving artifact is a "
            "torch.export program, denoiser.pt2; pass to_torch_export=True "
            "(--to-torch-export)")
    for flag, what in ((to_tflite, "TFLite"), (to_keras, "Keras")):
        if flag:
            raise _no_converter(what)
    from ..training.checkpoint import CheckpointManager

    dev = resolve_device(device)
    config = load_config(pipeline_config)
    manager = CheckpointManager(str(checkpoint_directory))
    step = manager.latest_step()
    if step is None:
        raise ValueError(f"no checkpoint found in [{checkpoint_directory}]")
    out_dir = Path(str(output_directory))
    out_dir.mkdir(parents=True, exist_ok=True)

    model = model_builder(config["model"]).hydra
    ckpt = manager.read(step)
    model.load_state_dict(ckpt["model"], strict=True)
    if use_ema and ckpt["ema_params"] is not None:
        names = {n for n, _ in model.named_parameters()}
        if set(ckpt["ema_params"]) != names:
            raise ValueError("the checkpoint's ema_params do not name the "
                             "model's parameters")
        model.load_state_dict(ckpt["ema_params"], strict=False)
        logger.info("exporting the EMA weights (train.ema was on; pass "
                    "use_ema=False for the raw iterate)")
    model = model.to(dev).eval().requires_grad_(False)
    # each collection's keys sorted, as JAX's export writes them (its
    # params have been through JAX's tree functions, which sort a dict)
    variables = {name: _sorted_tree(tree)
                 for name, tree in flax_from_params(model).items()}

    save_msgpack(out_dir / PARAMS_FILE, variables)
    save_config(config, str(out_dir / CONFIG_FILE))
    logger.info(f"wrote {out_dir / PARAMS_FILE} (checkpoint step {step})")

    shape = config["dataset"]["input_shape"]
    if quantize:
        from .quantize import calibrate, default_calibration_images
        if calibration_images is None:
            calibration_images = default_calibration_images(
                size=min(256, _dim(shape[0], 256)))
        save_msgpack(out_dir / QUANT_FILE,
                     calibrate(model, calibration_images))
        logger.info(f"wrote {out_dir / QUANT_FILE}")

    if to_torch_export:
        blob, _ = serialize_torch_export(model, reference_shape,
                                         channels=int(shape[2]))
        (out_dir / TORCH_EXPORT_FILE).write_bytes(blob)
        logger.info(f"wrote {out_dir / TORCH_EXPORT_FILE}")

    if test_model:
        probe = np.full((64, 64, int(shape[2])), 128, np.uint8)
        out = load_exported_model(out_dir, device=dev)(probe)
        if out.shape != probe.shape:
            raise RuntimeError(f"export self-test failed: {out.shape}")
        logger.info("export self-test passed")
    return str(out_dir)


def _sorted_tree(tree):
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def save_params_artifact(params, config: dict,
                         output_directory: Union[str, Path]) -> str:
    """Write a loadable artifact directory from a model (or its state
    dict) and a pipeline config (fine-tuned snapshots outside the train
    loop); only the params are written, as in JAX."""
    out = Path(str(output_directory))
    out.mkdir(parents=True, exist_ok=True)
    save_msgpack(out / PARAMS_FILE,
                 {"params": flax_from_params(params)["params"]})
    save_config(config, str(out / CONFIG_FILE))
    return str(out)


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
