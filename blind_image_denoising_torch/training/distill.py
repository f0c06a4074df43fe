"""Teacher-student distillation (counterpart of
``blind_image_denoising_tpu/training/distill.py``).

Config (``train.distillation``)::

    {
      "teacher": "unet_laplacian_v56_highnoise",  # registry name or
                                                  # exported artifact dir
      "weight": 1.0,      # weight of the student-vs-teacher term
      "gt_weight": 1.0,   # weight of the ordinary hard-GT losses
                          # (0: pure distillation)
      "dtype": "float32"  # "bfloat16" casts the teacher's every floating
                          # parameter and buffer to bf16
    }

The teacher is the artifact's hydra (``load_model(teacher).model``),
called directly on the train step's corrupted micro-batch, as JAX's
``model.apply(..., train=False)[0]``: no padding, TTA or blend. It is
frozen (``requires_grad_(False)``, run under ``torch.no_grad()``), so
its ConvNext units take the K1 kernel where their shapes allow, and only
its finest-scale output, in float32, is distilled.
"""

import logging
from typing import Callable, Tuple

import torch

from ..ops.resize import nchw, nhwc

logger = logging.getLogger("blind_image_denoising_torch")


def build_teacher(spec: dict, *, device=None) -> Tuple[Callable, dict]:
    """``train.distillation`` → ``(teacher_fn, options)``.
    ``teacher_fn(noisy)``: [B, H, W, C] float32 in [0, 255] → the
    teacher's finest-scale [B, H, W, C] float32 output, with no autograd
    record. ``options``: ``weight`` and ``gt_weight``. ``device``: None
    is the card (raises without one); ``"cpu"`` runs on the CPU."""
    teacher = spec.get("teacher")
    if not teacher:
        raise ValueError(
            "train.distillation needs a 'teacher' (pretrained registry "
            "name or exported artifact directory)")
    dtype_name = str(spec.get("dtype", "float32"))
    if dtype_name not in ("float32", "bfloat16"):
        raise ValueError(
            f"train.distillation.dtype must be float32 or bfloat16, "
            f"got [{dtype_name}]")
    options = {
        "weight": float(spec.get("weight", 1.0)),
        "gt_weight": float(spec.get("gt_weight", 1.0)),
    }
    if options["weight"] < 0 or options["gt_weight"] < 0:
        raise ValueError("distillation weights must be >= 0")
    if options["weight"] == 0 and options["gt_weight"] == 0:
        raise ValueError(
            "train.distillation: weight and gt_weight are both 0 — "
            "nothing would train")

    from .. import load_model
    model = load_model(str(teacher), device=device).model
    model.requires_grad_(False)
    cast = torch.bfloat16 if dtype_name == "bfloat16" else None
    if cast is not None:
        model.to(cast)

    def teacher_fn(noisy: torch.Tensor) -> torch.Tensor:
        x = noisy.to(cast) if cast is not None else noisy
        with torch.no_grad():
            y = model(nchw(x.contiguous()))[0]
        return nhwc(y).float()

    logger.info(
        f"distillation: teacher [{teacher}] ({dtype_name}), "
        f"weight {options['weight']}, gt_weight {options['gt_weight']}")
    return teacher_fn, options
