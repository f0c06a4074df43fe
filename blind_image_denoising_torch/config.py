"""Configuration IO (counterpart of ``blind_image_denoising_tpu/config.py``):
``load_config``, ``save_config``, ``input_shape_fixer``.

Pipeline configs are the JSON files the JAX package writes and ships:
four top-level sections ``model{backbone,denoiser} / train / loss /
dataset`` and ``"?"`` wildcards for dynamic spatial dims.
"""

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Union


def load_config(config: Union[str, Dict, Path]) -> Dict:
    """Load a configuration from a dict or a JSON file path."""
    if config is None:
        raise ValueError("config should not be empty")
    if isinstance(config, dict):
        return config
    if isinstance(config, (str, Path)):
        path = str(config)
        if not os.path.isfile(path):
            raise ValueError(f"configuration path [{path}] is not valid")
        with open(path, "r") as f:
            return json.load(f)
    raise ValueError(f"don't know how to handle config [{config}]")


def save_config(config: Union[str, Dict, Path],
                filename: Union[str, Path]) -> None:
    """Persist a configuration (dict or path) to ``filename`` as JSON."""
    config = load_config(config)
    if not filename:
        raise ValueError("filename cannot be null or empty")
    logging.getLogger("blind_image_denoising_torch").info(
        f"saving configuration pipeline to [{filename}]")
    with open(filename, "w") as f:
        json.dump(obj=config, fp=f, indent=4)


def input_shape_fixer(input_shape: List) -> List:
    """Replace '?'/''/'-1' placeholders with None (dynamic dim)."""
    input_shape = list(input_shape)
    for i, shape in enumerate(input_shape):
        if shape in ("?", "", "-1"):
            input_shape[i] = None
    return input_shape
