"""The layer library (counterpart of
``blind_image_denoising_tpu/layers``): NCHW ``torch.nn`` modules under
the JAX package's names. A module with a kernel regularizer has a
``penalty()``; ``ops/regularizers.regularization_loss`` sums them."""

from .activations import Activation, activation_fn
from .conv import ConvBlock, DenseBlock, default_bn_args, default_ln_args
from .multipliers import (
    ChannelLearnableMultiplier,
    SmoothChannelLearnableMultiplier,
    GlobalLearnableMultiplier,
    Multiplier,
    ChannelwiseMultiplier,
)
from .convnext import ConvNextBlock
from .stochastic import StochasticDepth, RandomOnOff
from .attention import (
    AdditiveAttentionGate,
    ConvolutionalSelfAttention,
    NonLocalAttention,
    logit_norm,
)
from .se import SqueezeExcite
from .selector import SelectorBlock
from .sampling import Upsample, Downsample
from .misc import GaussianFilter, ValueCompressor, SparseBlock, GatedMLP
from .blocks import ResnetBlocks, DenseGate
