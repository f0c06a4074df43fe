"""The two other packaged artifacts through the port, and the modules they
need, against the JAX package on the CPU.

* Package surface: ``configs`` / ``CONFIGS_DICT`` equal the JAX
  package's; ``__all__`` lacks only the names on ``NOT_PORTED``, each
  with its ROADMAP item.
* The ``layers`` / ``ops`` / ``models`` / ``inference`` subpackages
  export the JAX subpackages' public names, each bound to the port's
  counterpart (JAX's kernel names to the port's wrappers).
* Tiny seeded ``resnet`` and ``convnext`` hydras (the two packaged resnet
  configs, the artifact's, and one with every skeleton option the port
  has), converted by ``weights.params_from_flax`` from numpy draws of
  the flax variables: outputs within 0.05 gray levels of
  ``hydra.apply``, regularization sums within 1e-5 relative.
* ``resnet_depthwise_scratch`` and ``unet_laplacian_v56_highnoise`` in
  float32 against ``bid.load_model(name, dtype="float32")`` on noisy
  evaluation crops: uint8 within 1 gray level, ≥ 99% equal. The resnet
  in bf16 (its pipeline's dtype) against JAX bf16: mean ≤ 1.0, p99 ≤ 3.
* v56 with ``quant=True`` against JAX's ``quant=True``: mean ≤ 1.0 gray
  level, and p99 no larger than JAX's own int8 path moves when one
  LayerNorm scale is multiplied by (1 + 1e-6) (at least 3). The int8
  chain is chaotic: one code that lands on the other side of a rounding
  boundary (a LayerNorm's sum in another order) spreads through the 55
  quantized convs, and JAX against itself so perturbed moves p99 5–7
  gray levels on these crops. Site by site the port is exact
  (``tests/test_torch_ops.py``: codes, accumulators and the rescale).
* ``calibrate`` against JAX's on seeded images (the v56, a resnet
  hydra and the flagship, whose ConvNext units record their three sites
  each as JAX's do): the same sites, scales within rtol 1e-3;
  ``default_calibration_images`` and ``load_evaluation_images`` equal.
* ``quant=True`` on an artifact without ``quant.msgpack`` raises
  ``ValueError``; the v56's scales attach to every site they name.
"""

import copy
import importlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.images import load_evaluation_images
from blind_image_denoising_tpu.inference import quantize as jquantize
from blind_image_denoising_tpu.inference.denoiser import (
    Denoiser as JaxDenoiser)
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.training.losses import sum_losses_collection
from blind_image_denoising_torch import images as timages
from blind_image_denoising_torch.inference import quantize as tquantize
from blind_image_denoising_torch.inference.denoiser import Denoiser
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops.regularizers import regularization_loss
from blind_image_denoising_torch.weights import (attach_quant_scales,
                                                 load_msgpack,
                                                 params_from_flax)

RESNET = "resnet_depthwise_scratch"
V56 = "unet_laplacian_v56_highnoise"
FLAGSHIP = "unet_laplacian_v6_tpu_scratch"

# names of the JAX package's __all__ that the port does not have yet
NOT_PORTED = {}


def _noisy(size, sigma, n=3, seed=0):
    clean = load_evaluation_images(size)[:n]
    rng = np.random.default_rng(seed)
    return np.clip(np.round(clean + rng.normal(0, sigma, clean.shape)),
                   0, 255).astype(np.uint8)


def _gray_diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


# ---------------------------------------------------------------- surface

def test_package_surface_matches_jax(tmp_path):
    assert [n for n, _ in bidt.configs] == [n for n, _ in bid.configs]
    assert [c for _, c in bidt.configs] == [c for _, c in bid.configs]
    assert bidt.CONFIGS_DICT == bid.CONFIGS_DICT
    missing = set(bid.__all__) - set(bidt.__all__)
    assert missing == set(NOT_PORTED), missing
    assert not set(bidt.__all__) - set(bid.__all__)
    for name in bidt.__all__:
        assert getattr(bidt, name) is not None, name
    path = tmp_path / "c.json"
    bidt.save_config(bidt.CONFIGS_DICT["unet_laplacian_v6"], path)
    assert json.loads(path.read_text()) == bid.CONFIGS_DICT[
        "unet_laplacian_v6"]


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("sub", ["layers", "ops", "models", "inference",
                                 "parallel"])
def test_subpackage_surface_matches_jax(sub):
    jax_sub = importlib.import_module(f"blind_image_denoising_tpu.{sub}")
    port_sub = importlib.import_module(f"blind_image_denoising_torch.{sub}")
    assert _public(port_sub) == _public(jax_sub)
    for name in _public(port_sub):
        assert getattr(port_sub, name) is not None, name
    if sub == "ops":
        assert port_sub.regularizers.builder("l1") is not None
        from blind_image_denoising_torch.ops import (pallas_noise,
                                                     pallas_pyramid)
        assert port_sub.corrupt_batch_pallas is pallas_noise.corrupt_noise
        assert (port_sub.laplacian_band_split_pallas
                is pallas_pyramid.band_split)
        assert (port_sub.laplacian_band_split_reference
                is pallas_pyramid.band_split_plain)
    # the registry dict still shadows the models subpackage at the top
    assert isinstance(bidt.models, dict)


# ---------------------------------------------------------------- tiny hydras

def _narrow(backbone, **extra):
    b = dict(backbone, filters=8, no_layers=2, block_filters=[8, 32, 8],
             **extra)
    return {"backbone": b, "denoiser": {"output_channels": 3,
                                        "kernel_regularizer": "l2"}}


_RESNET_L1 = ("resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_"
              "relu")
_RESNET_ERF = ("resnet_color_1x9_bn_32x64x32_1x3x1_256x256_depthwise_erf_"
               "relu")
_CONVNEXT = {"type": "convnext", "input_shape": ["?", "?", 3],
             "kernel_size": 3, "block_kernels": [7, 1, 1],
             "block_depthwise": [1, -1, -1], "value_range": [0, 255]}


@pytest.mark.parametrize("which", ["l1", "erf", "artifact", "options",
                                   "convnext"])
def test_tiny_seeded_hydra_matches_jax(which):
    if which == "convnext":
        mc = _narrow(_CONVNEXT)
    elif which == "artifact":
        with open(bid.models[RESNET]["configuration"]) as f:
            mc = _narrow(json.load(f)["model"]["backbone"])
    else:
        base = bid.CONFIGS_DICT[_RESNET_ERF if which == "erf"
                                else _RESNET_L1]["model"]["backbone"]
        extra = {}
        if which == "options":
            extra = dict(batchnorm="bias_free", use_bias=True,
                         add_initial_bn=True, add_final_bn=True,
                         add_concat_input=True, add_channelwise_scaling=True,
                         add_learnable_multiplier=True,
                         add_mean_sigma_normalization=True)
        mc = _narrow(copy.deepcopy(base), **extra)
    jhydra = jax_model_builder(copy.deepcopy(mc)).hydra
    x = np.random.default_rng(1).uniform(0, 255, (2, 40, 48, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda: jhydra.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = str(path[-1].key)
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name in ("var", "mean_sq"):
            return rng.uniform(0.5, 2.0, leaf.shape)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape)
        return rng.normal(0, 0.2, leaf.shape)

    variables = {k: jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes[k])
        for k in ("params", "batch_stats") if k in shapes}
    refs, sown = jhydra.apply(variables, jnp.asarray(x), train=False,
                              mutable=["losses"])
    port = model_builder(copy.deepcopy(mc)).hydra
    port.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(refs) == 1
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(refs[0]), atol=0.05)
    ref_reg = float(sum_losses_collection(sown))
    assert float(regularization_loss(port).detach()) == pytest.approx(
        ref_reg, rel=1e-5)


# ---------------------------------------------------------------- artifacts

@pytest.fixture(scope="module")
def jax_v56_int8():
    return bid.load_model(V56, quant=True)


@pytest.mark.parametrize("name,sigma", [(RESNET, 25.0), (V56, 60.0)])
def test_artifact_f32_serving_matches_jax(name, sigma):
    img = _noisy(96, sigma)
    ref = bid.load_model(name, dtype="float32")(img)
    port = bidt.load_model(name, device="cpu", dtype="float32")
    assert port.model.dtype is None
    got = port(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    diff = _gray_diff(got, ref)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_v56_serves_in_float32_by_default():
    assert bidt.load_model(V56, device="cpu").model.dtype is None


def test_resnet_bf16_serving_close_to_jax_bf16():
    img = _noisy(128, 25.0)
    port = bidt.load_model(RESNET, device="cpu")         # bf16 from pipeline
    assert port.model.dtype == torch.bfloat16
    diff = _gray_diff(port(img), bid.load_model(RESNET)(img))
    assert diff.mean() <= 1.0, diff.mean()
    assert np.percentile(diff, 99) <= 3, np.percentile(diff, 99)


def test_v56_int8_serving_close_to_jax_int8(jax_v56_int8):
    img = _noisy(128, 10.0)
    port = bidt.load_model(V56, device="cpu", quant=True)
    ref = np.asarray(jax_v56_int8(img))
    diff = _gray_diff(port(img), ref)
    # JAX against itself with one LayerNorm scale moved by 1e-6 relative
    v = jax_v56_int8.variables
    params = dict(v["params"])
    params["enc_0_0"] = dict(params["enc_0_0"], ln={
        "scale": params["enc_0_0"]["ln"]["scale"] * (1 + 1e-6)})
    moved = JaxDenoiser(jax_v56_int8.model, dict(v, params=params),
                        quant=True)
    own = _gray_diff(moved(img), ref)
    print(f"v56 int8 vs JAX: mean {diff.mean():.3f}, p99 "
          f"{np.percentile(diff, 99)}; JAX vs itself moved by 1e-6: mean "
          f"{own.mean():.3f}, p99 {np.percentile(own, 99)}")
    assert diff.mean() <= 1.0, diff.mean()
    assert np.percentile(diff, 99) <= max(3.0, np.percentile(own, 99))


def test_quant_scales_attach_to_every_site():
    model = bidt.load_model(V56, device="cpu", quant=True).model
    tree = load_msgpack(bid.models[V56]["directory"] + "/quant.msgpack")
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert sum(name.endswith("_scale")
               for name, _ in model.named_buffers()) == n_leaves
    assert float(model.enc_0_0.dw_scale) == float(tree["enc_0_0"]["dw_scale"])
    assert float(model.stem_scale) == float(tree["stem_scale"])


def test_quant_without_scales_raises():
    with pytest.raises(ValueError, match="quant.msgpack"):
        bidt.load_model(RESNET, device="cpu", quant=True)
    model = bidt.load_model(V56, device="cpu").model
    with pytest.raises(ValueError, match="calibrat"):
        Denoiser(model, quant=True, device="cpu")


# ---------------------------------------------------------------- calibration

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.asarray(v))
    return out


def test_evaluation_and_calibration_images_match_jax():
    np.testing.assert_array_equal(timages.load_evaluation_images(48),
                                  load_evaluation_images(48))
    np.testing.assert_array_equal(
        tquantize.default_calibration_images(size=32, seed=3),
        jquantize.default_calibration_images(size=32, seed=3))


@pytest.mark.parametrize("name", [V56, RESNET, FLAGSHIP])
def test_calibrate_matches_jax(name):
    images = _noisy(64, 40.0, n=4, seed=5).astype(np.float32)
    jden = bid.load_model(name, dtype="float32")
    ref = _flat(jquantize.calibrate(jden.model, jden.variables, images,
                                    batch_size=2)["quant"])
    model = bidt.load_model(name, device="cpu", dtype="float32").model
    got = _flat(tquantize.calibrate(model, images, batch_size=2))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-3), k
    # the scales serve: attached to a fresh model, an int8 Denoiser runs
    fresh = bidt.load_model(name, device="cpu", dtype="float32").model
    assert attach_quant_scales(fresh, tquantize.calibrate(
        fresh, images[:1])) == len(ref)
    out = Denoiser(fresh, quant=True, device="cpu")(images[0].astype(np.uint8))
    assert out.shape == images[0].shape
