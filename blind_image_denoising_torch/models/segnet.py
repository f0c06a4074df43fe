"""SegNet backbone: an unimplemented stub that raises when called, as in
``blind_image_denoising_tpu/models/segnet.py`` (and the reference)."""

from typing import Any, Dict

from torch import nn


class SegnetBackbone(nn.Module):
    def __init__(self, config: Dict[str, Any], in_channels: int = 3,
                 dtype=None):
        super().__init__()
        self.out_features = []

    def forward(self, x, train: bool = False, generator=None):
        raise NotImplementedError("segnet backbone is not implemented "
                                  "(stub, as in the reference)")
