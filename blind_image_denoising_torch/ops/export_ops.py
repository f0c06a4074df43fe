"""The forward launches of K1 (``pallas_convnext.convnext_block``) and K2
(``pallas_pyramid.band_smooth``'s forward) as PyTorch custom operators,
``bidt::convnext_block`` and ``bidt::band_smooth``, for ``torch.export``
alone.

``torch.export`` cannot trace into a launch through ``ctypes``
(``ops/cuda_build.py``), so while a program is being exported
(``torch.compiler.is_exporting()``) the ConvNext units and the band
split call these operators instead of the wrappers: the exported graph
then holds one ``bidt.convnext_block`` node per unit and one
``bidt.band_smooth`` node per split, where a graph traced through the
units' PyTorch branch would hold library convolutions. Each operator's
implementation is the wrapper itself, so a loaded program launches the
hand kernels on a CUDA tensor (and counts them in the wrappers'
``launches``) and runs their plain versions on a CPU tensor; its fake
implementation gives the output's shape and dtype to the tracer. Both
carry no shape of their own: ``bidt::convnext_block`` takes every (C, K)
the wrapper does (any C, odd K and E, as JAX's kernel). The
eager serving path, the training path, K2's ``autograd.Function`` and
its ``jvp`` do not use them.

Importing this module registers the operators; ``load_torch_export``
imports it before ``torch.export.load``, which needs them to rebuild the
graph.
"""

from typing import Tuple

import torch

from . import pallas_convnext, pallas_pyramid


@torch.library.custom_op("bidt::convnext_block", mutates_args=())
def convnext_block(x: torch.Tensor, dw: torch.Tensor, ln_scale: torch.Tensor,
                   w2: torch.Tensor, w3: torch.Tensor, gain: torch.Tensor,
                   slope: float) -> torch.Tensor:
    return pallas_convnext.convnext_block(x, dw, ln_scale, w2, w3, gain,
                                          slope)


@convnext_block.register_fake
def _(x, dw, ln_scale, w2, w3, gain, slope):
    return x.new_empty(x.shape)


@torch.library.custom_op("bidt::band_smooth", mutates_args=())
def band_smooth(x: torch.Tensor,
                kernel_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return pallas_pyramid.band_smooth_forward(x, kernel_size)


@band_smooth.register_fake
def _(x, kernel_size):
    return x.new_empty(x.shape), x.new_empty(x.shape)
