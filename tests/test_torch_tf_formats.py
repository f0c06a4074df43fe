"""The artifacts JAX writes through ``jax2tf`` and TensorFlow, read by the
port, on the CPU: the SavedModel (``inference/savedmodel.py``) and the
``.keras`` HydraLayer archive (``inference/keras_export.py``).

* SavedModel: JAX's ``save_denoiser_savedmodel`` of the packaged
  ``resnet_depthwise_scratch`` (a uint8 ``[None, None, None, 3]``
  signature), in the reference's ``artifact/denoiser/`` layout, served by
  the port's ``load_model(dir, device="cpu")`` and by JAX's
  ``load_model``: the same uint8 images (TensorFlow runs both), for a
  batch and for one image; on the default device ``load_model`` raises,
  since TensorFlow would run the graph off the card. The writer raises.
* HydraLayer: JAX's ``save_hydra_keras`` of a resnet hydra (the packaged
  resnet's config with BatchNorm off and 2 layers, from a seeded JAX
  init), read by the port's ``load_hydra_keras``: every scale output
  within 1e-2 of JAX's ``load_hydra_keras`` on [0, 255] (TensorFlow runs
  JAX's graph; the TFLite bar). JAX's writer
  fails on a hydra with ``batch_stats`` (the packaged resnet):
  ``tf_keras`` lists a layer's trainable weights first, and
  ``set_weights`` then meets the leaves in JAX's order, ``batch_stats``
  first. The port's reader takes Keras's order; the writer raises.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.inference.keras_export import (
    load_hydra_keras as jax_load_hydra_keras, save_hydra_keras)
from blind_image_denoising_tpu.inference.savedmodel import (
    save_denoiser_savedmodel)
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_torch.inference import keras_export, savedmodel

RESNET = "resnet_depthwise_scratch"


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def savedmodel_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("savedmodel")
    den = bid.load_model(RESNET, dtype="float32")
    save_denoiser_savedmodel(den.model, den.variables,
                             str(root / "denoiser"))
    return root


def test_savedmodel_serves_as_jax(savedmodel_dir):
    assert savedmodel.find_savedmodel(str(savedmodel_dir)) == str(
        savedmodel_dir / "denoiser")
    port = bidt.load_model(savedmodel_dir, device="cpu")
    ref = bid.load_model(str(savedmodel_dir))
    batch = _images(2, 40, 56)
    got = port(batch)
    assert got.dtype == np.uint8 and got.shape == batch.shape
    np.testing.assert_array_equal(got, ref(batch))
    np.testing.assert_array_equal(port(batch[0].astype(np.float32)),
                                  got[0])


def test_savedmodel_is_cpu_only(savedmodel_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="device='cpu'"):
        bidt.load_model(savedmodel_dir)
    with pytest.raises(NotImplementedError, match="no converter"):
        savedmodel.save_denoiser_savedmodel(None, None, "unused")


@pytest.fixture(scope="module")
def hydra_archive(tmp_path_factory):
    path = tmp_path_factory.mktemp("hydra_keras") / "model_hydra.keras"
    mc = copy.deepcopy(bid.load_config(
        bid.models[RESNET]["configuration"])["model"])
    mc["backbone"].update(batchnorm=False, no_layers=2)
    hydra = jax_model_builder(mc).hydra
    variables = hydra.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 32, 32, 3)), train=False)
    save_hydra_keras(mc, {"params": variables["params"]}, str(path))
    return path


def test_hydra_keras_reads_as_jax(hydra_archive):
    x = np.random.default_rng(1).uniform(0, 255, (2, 48, 80, 3)).astype(
        np.float32)
    ref = jax_load_hydra_keras(str(hydra_archive))(x)
    got = keras_export.load_hydra_keras(str(hydra_archive),
                                        device="cpu")(x)
    assert len(got) == len(ref) == 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float(np.abs(g - r).max()) <= 1e-2
    with pytest.raises(NotImplementedError, match="no converter"):
        keras_export.save_hydra_keras({}, {}, str(hydra_archive))
