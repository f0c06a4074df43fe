"""Weight import: the reference's pretrained ``model_hydra.keras`` → the
port's :class:`~..models.unet_laplacian_v56.UnetLaplacianV56` (counterpart
of ``blind_image_denoising_tpu/inference/import_v56.py``).

The Keras-v2 ``.keras`` archive is a zip holding ``model.weights.h5``;
its float32 tensors are read with ``zipfile`` and ``h5py`` (imported on
this path only; a missing ``h5py`` raises ``ImportError``) and mapped by
layer name onto the flax variables tree the JAX import builds: Keras
Conv2D kernels are HWIO already, DepthwiseConv2D kernels (H, W, C, 1)
become (H, W, 1, C), a gain (1, 1, 1, C) becomes (C,). The Denoiser then
converts the tree to the model's OIHW state dict
(``weights.params_from_flax``), as for a ``params.msgpack``.

A damaged or foreign archive — not a zip, no ``model.weights.h5``, a
missing layer, a tree that does not fit the model — raises
:class:`KerasImportError`, which ``load_model`` catches to fall through
to the TFLite graph, as JAX does; nothing else is caught there.
"""

import io
import logging
import zipfile
from typing import Dict, Tuple

import numpy as np

from ..models.unet_laplacian_v56 import UnetLaplacianV56
from ..weights import params_from_flax

logger = logging.getLogger("blind_image_denoising_torch")

_PREFIX = "_layer_checkpoint_dependencies/"


class KerasImportError(ValueError):
    """The archive could not be read into the model."""


def import_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading a .keras archive needs the 'h5py' "
                          "package (model.weights.h5 is HDF5)") from e
    return h5py


def read_keras_weights(path: str) -> Dict[str, np.ndarray]:
    """{cleaned/layer/path: array} from a .keras zip archive."""
    h5py = import_h5py()
    try:
        with zipfile.ZipFile(path) as z:
            data = z.read("model.weights.h5")
        out: Dict[str, np.ndarray] = {}
        with h5py.File(io.BytesIO(data), "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    clean = name.replace(_PREFIX, "").replace("/vars/0", "")
                    out[clean] = np.asarray(obj)
            f.visititems(visit)
    except (OSError, KeyError, zipfile.BadZipFile) as e:
        raise KerasImportError(str(e)) from e
    logger.info(f"read {len(out)} weight tensors from {path}")
    return out


def _dw(w: np.ndarray) -> np.ndarray:
    """Keras depthwise (H, W, C, 1) → the flax (H, W, 1, C)."""
    return np.ascontiguousarray(np.transpose(w, (0, 1, 3, 2)))


def _gamma(w: np.ndarray) -> np.ndarray:
    """ChannelLearnableMultiplier raw weight (1, 1, 1, C) → (C,)."""
    return np.ascontiguousarray(w.reshape(-1))


def build_pretrained_v56(keras_path: str, dtype=None
                         ) -> Tuple[UnetLaplacianV56, dict]:
    """(model, variables): the port's v5.6 model in ``dtype`` (None:
    float32; the weights stay float32 either way) and the flax variables
    tree of the archive's weights, which fit it."""
    w = read_keras_weights(keras_path)
    bb = "functional_1/functional/"

    def get(name: str) -> np.ndarray:
        try:
            return w[name]
        except KeyError:
            raise KerasImportError(
                f"[{keras_path}] has no weight [{name}]") from None

    def block(name: str) -> Dict:
        return {"conv_1": _dw(get(f"{bb}{name}/conv_1")),
                "conv_2": get(f"{bb}{name}/conv_2"),
                "conv_3": get(f"{bb}{name}/conv_3"),
                "ln": {"scale": get(f"{bb}{name}/ln")},
                "gamma": {"w": _gamma(get(f"{bb}{name}/gamma"))}}

    def attn(name: str) -> Dict:
        out = {k: get(f"{bb}{name}/{k}") for k in
               ("query_conv", "key_conv", "value_conv", "output_fn")}
        out.update({k: {"scale": get(f"{bb}{name}/{k}")}
                    for k in ("ln_0", "ln_1")})
        out["gamma"] = {"w": _gamma(get(f"{bb}{name}/gamma"))}
        return out

    def cnb(i: int) -> str:
        return "conv_next_block" + ("" if i == 0 else f"_{i}")

    def csa(i: int) -> str:
        return "convolutional_self_attention" + ("" if i == 0 else f"_{i}")

    params = {"stem": get(bb + "conv2d"), "down_0": get(bb + "conv2d_2"),
              "down_1": get(bb + "conv2d_4"), "up_1": get(bb + "conv2d_6"),
              "up_0": get(bb + "conv2d_8")}
    for d, base in ((0, 0), (1, 6)):
        for i in range(3):
            params[f"enc_{d}_{i}"] = block(cnb(base + 2 * i))
    for d, base in ((1, 12), (0, 18)):
        for i in range(3):
            params[f"dec_{d}_{i}"] = block(cnb(base + 2 * i))
    for i in range(3):
        params[f"attn_{i}"] = attn(csa(2 * i))
    # the standalone output norms and heads (functional_3/5/7: scales
    # 0/1/2)
    ln_names = {0: "layer_normalization", 1: "layer_normalization_2",
                2: "layer_normalization_4"}
    for i, fn in ((0, "functional_3"), (1, "functional_5"),
                  (2, "functional_7")):
        params[f"out_ln_{i}"] = {"scale": get(bb + ln_names[i])}
        params[f"head_{i}_conv_0"] = get(f"{fn}/conv2d")
        params[f"head_{i}_conv_1"] = get(f"{fn}/conv2d_2")

    model = UnetLaplacianV56(dtype=dtype)
    variables = {"params": params}
    # the structure against the model: names and shapes
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params_from_flax(variables).items()}
    if got != expected:
        wrong = {k: (expected[k], got[k]) for k in set(got) & set(expected)
                 if got[k] != expected[k]}
        raise KerasImportError(
            f"import structure mismatch: missing "
            f"{sorted(set(expected) - set(got))}, extra "
            f"{sorted(set(got) - set(expected))}, shapes {wrong}")
    return model, variables
