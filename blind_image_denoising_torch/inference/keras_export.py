"""The JAX package's ``.keras`` HydraLayer archive, read into the port
(counterpart of ``blind_image_denoising_tpu/inference/keras_export.py``).

JAX's ``save_hydra_keras`` saves the hydra as a ``tf_keras`` model with
one custom layer, ``HydraLayer``: its config carries the pipeline's
``model`` section and the input channels, and its weights are the
flattened Flax variable leaves, stored in ``model.weights.h5`` as
``layers/hydra_layer/vars/<i>``. Keras lists a layer's trainable
weights (the ``params`` leaves) before the others (``batch_stats``),
each group in JAX's flattening order (dict keys sorted at every level).
:func:`load_hydra_keras` reads the config and the leaves with
``zipfile``, ``json`` and ``h5py`` (imported on this path only; a
missing one raises ``ImportError``), builds the port's hydra from the
config, loads the leaves by path and returns JAX's callable: float32
NHWC → the list of scale outputs.

Writing the archive is not ported (:func:`save_hydra_keras` raises):
JAX's layer computes through a ``jax2tf`` graph, and no converter from
PyTorch to TensorFlow is installed (``ai_edge_torch`` and ``onnx`` do
not import).
"""

import io
import json
import logging
import zipfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.hydra import model_builder
from ..weights import flax_from_params, params_from_flax
from .denoiser import resolve_device
from .import_v56 import import_h5py

logger = logging.getLogger("blind_image_denoising_torch")

KERAS_FILE = "model_hydra.keras"
_VARS = "layers/hydra_layer/vars"


def _leaf_paths(tree: Dict, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, ...]]:
    """The leaf paths of a nested dict in JAX's flattening order."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += _leaf_paths(tree[key], prefix + (key,))
        else:
            out.append(prefix + (key,))
    return out


def _hydra_layer_config(config: Dict) -> Dict:
    for layer in config["config"]["layers"]:
        if layer["class_name"] == "HydraLayer":
            return layer["config"]
    raise ValueError("the archive holds no HydraLayer")


def save_hydra_keras(model_config: dict, variables, path: str,
                     channels=None) -> str:
    raise NotImplementedError(
        "writing a .keras HydraLayer archive is not available: JAX's "
        "layer computes through a jax2tf graph, and no converter from "
        "PyTorch to TensorFlow is installed (ai_edge_torch, onnx)")


def load_hydra_keras(path: str, device=None):
    """An archive written by JAX's ``save_hydra_keras`` → a callable
    (float32 NHWC in the model's value range → the list of scale
    outputs, NHWC numpy arrays) on ``device`` (default: the card)."""
    h5py = import_h5py()
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        layer = _hydra_layer_config(json.loads(z.read("config.json")))
        data = z.read("model.weights.h5")
    hydra = model_builder(layer["model_config"]).hydra
    template = flax_from_params(hydra)
    order = ([("params",) + p for p in _leaf_paths(template["params"])]
             + [("batch_stats",) + p
                for p in _leaf_paths(template.get("batch_stats", {}))])
    variables: Dict = {}
    with h5py.File(io.BytesIO(data), "r") as f:
        stored = f[_VARS]
        if len(stored) != len(order):
            raise ValueError(f"[{path}] holds {len(stored)} weights, the "
                             f"config's hydra {len(order)}")
        for i, keys in enumerate(order):
            leaf = np.asarray(stored[str(i)])
            node = template
            for k in keys:
                node = node[k]
            if leaf.shape != node.shape:
                raise ValueError(f"weight {i} ({'/'.join(keys)}) has shape "
                                 f"{leaf.shape}, the hydra {node.shape}")
            tree = variables
            for k in keys[:-1]:
                tree = tree.setdefault(k, {})
            tree[keys[-1]] = leaf
    hydra.load_state_dict(params_from_flax(variables), strict=True)
    hydra = hydra.to(dev).eval().requires_grad_(False)
    logger.info(f"read the HydraLayer archive [{path}] ({len(order)} "
                f"weight tensors)")

    def forward(x) -> List[np.ndarray]:
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        with torch.no_grad():
            outs = hydra(x.permute(0, 3, 1, 2))
        return [o.permute(0, 2, 3, 1).cpu().numpy() for o in outs]

    return forward
