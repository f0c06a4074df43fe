"""Model assembly (counterpart of ``blind_image_denoising_tpu/models``):
the backbones and the hydra (normalizer → backbone → denoiser heads →
denormalizer), built from the JAX package's config schema."""

from .resnet import ResnetBackbone, ConvNextBackbone
from .unet import UnetBackbone
from .unet_laplacian import UnetLaplacianBackbone
from .segnet import SegnetBackbone
from .hydra import (
    Hydra,
    DenoiserHead,
    BuilderResults,
    model_builder,
    backbone_from_config,
)
