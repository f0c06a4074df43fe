"""Gaussian and Laplacian pyramids (counterpart of
``blind_image_denoising_tpu/ops/pyramid.py``) on NHWC tensors: the
package's ``build_pyramid_model`` / ``build_inverse_pyramid_model``.

Down: ``avg_pool_same(x, kernel_size, (2, 2))``, TF's count-aware SAME
average pool; up: ``upsample_2x_bilinear`` with half-pixel centres. The
forward and inverse of each type reconstruct the input to float32
rounding. Plain PyTorch ops, as JAX runs these in XLA (the decimating
band-split kernel K4 is not on this path).
"""

from enum import Enum
from typing import Callable, Dict, List, Optional

import torch

from .resize import avg_pool_same, upsample_2x_bilinear

DEFAULT_KERNEL_SIZE = (5, 5)


class PyramidType(Enum):
    NONE = 1
    GAUSSIAN = 2
    LAPLACIAN = 3

    @staticmethod
    def from_string(type_str: str) -> "PyramidType":
        if (type_str is None or not isinstance(type_str, str)
                or not type_str.strip()):
            raise ValueError(f"invalid pyramid type [{type_str}]")
        return PyramidType[type_str.strip().upper()]

    def to_string(self) -> str:
        return self.name


def gaussian_pyramid(x: torch.Tensor, levels: int,
                     kernel_size=DEFAULT_KERNEL_SIZE) -> List[torch.Tensor]:
    """Level 0 is the input; each next level a 2× average-pool
    downsample."""
    scales = [x]
    for _ in range(1, levels):
        x = avg_pool_same(x, kernel_size, (2, 2))
        scales.append(x)
    return scales


def inverse_gaussian_pyramid(levels: List[torch.Tensor]) -> torch.Tensor:
    """Upsample chain with the detail of each level re-injected."""
    output = previous = None
    for level_x in reversed(levels):
        if output is None:
            output = previous = level_x
        else:
            output = upsample_2x_bilinear(output)
            output = output + (level_x - upsample_2x_bilinear(previous))
            previous = level_x
    return output


def laplacian_pyramid(x: torch.Tensor, levels: int,
                      kernel_size=DEFAULT_KERNEL_SIZE) -> List[torch.Tensor]:
    """Band-pass levels ``x − up(down(x))`` and the lowpass base last."""
    scales = []
    for _ in range(levels - 1):
        down = avg_pool_same(x, kernel_size, (2, 2))
        scales.append(x - upsample_2x_bilinear(down))
        x = down
    scales.append(x)
    return scales


def inverse_laplacian_pyramid(levels: List[torch.Tensor]) -> torch.Tensor:
    """Upsample-and-add reconstruction."""
    output = None
    for level_x in reversed(levels):
        output = (level_x if output is None
                  else upsample_2x_bilinear(output) + level_x)
    return output


def build_pyramid_fn(config: Optional[Dict]
                     ) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """The forward pyramid a config (``levels``, ``kernel_size``,
    ``type``) describes; None is the 1-level passthrough."""
    if config is None:
        levels, kernel_size, ptype = 1, DEFAULT_KERNEL_SIZE, PyramidType.NONE
    else:
        levels = config.get("levels", 1)
        kernel_size = tuple(config.get("kernel_size", DEFAULT_KERNEL_SIZE))
        ptype = PyramidType.from_string(config.get("type", "NONE"))
    if ptype in (PyramidType.GAUSSIAN, PyramidType.NONE):
        return lambda x: gaussian_pyramid(x, levels, kernel_size)
    return lambda x: laplacian_pyramid(x, levels, kernel_size)


def build_inverse_pyramid_fn(config: Optional[Dict]
                             ) -> Callable[[List[torch.Tensor]], torch.Tensor]:
    """The inverse of :func:`build_pyramid_fn`'s pyramid."""
    ptype = (PyramidType.NONE if config is None
             else PyramidType.from_string(config.get("type", "NONE")))
    if ptype in (PyramidType.GAUSSIAN, PyramidType.NONE):
        return inverse_gaussian_pyramid
    return inverse_laplacian_pyramid
