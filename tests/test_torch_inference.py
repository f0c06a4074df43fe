"""The port's ``Denoiser`` surface against the JAX package's, on the CPU.

* ``ops/padding.py`` equal to JAX's.
* The shared tiny resnet hydra (``conftest.tiny_resnet_hydra``), loaded
  into the port through ``Denoiser(model, variables)``: ``float_forward``
  within 1e-4 of JAX's for pow2 and multiple padding, row, column and
  grid tiling, TTA with 2, 4 and 8 members and TTA with tiling; the
  uint8 ``__call__`` within 1 gray level, ≥ 99% equal; the gradient of
  ``float_forward``'s sum against ``jax.grad`` of JAX's, cosine ≥ 0.9999.
* The packaged flagship in float32 with its blend at ≤ 192×128,
  untiled, tiled with ``tile_rows=64`` and with ``tta=8``: uint8 within
  1 gray level, ≥ 99% equal (``tests/test_torch_model.py``'s serving
  bar); its ``float_forward`` gradient, cosine ≥ 0.9999.
* JAX's own exactness checks (``tests/test_inference.py``) on the port
  alone: any-size uint8 contract, TTA equivariance and its subgroups,
  the float mode, tiled equal to untiled.
* ``flax_from_params`` inverts ``params_from_flax`` on the three packaged
  artifacts (with v5.6's int8 scales); ``dispatch`` and ``HostCopy``; the
  registry's ``BID_TPU_PRETRAINED_PATH`` roots, a reference-style root
  (the TFLite fixture) serving uint8 and raising JAX's "neither" error
  for ``tta``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.config import load_config
from blind_image_denoising_tpu.images import load_evaluation_images
from blind_image_denoising_tpu.inference.denoiser import (
    Denoiser as JaxDenoiser)
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.ops import padding as jpadding
from blind_image_denoising_torch.inference.denoiser import (Denoiser,
                                                            HostCopy)
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops import padding as tpadding
from blind_image_denoising_torch.parallel import create_mesh
from blind_image_denoising_torch.weights import (flax_from_params,
                                                 load_msgpack)
from conftest import TINY_RESNET_MODEL, tiny_resnet_hydra

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX hydra, numpy variables) of the shared tiny model."""
    hydra, variables = tiny_resnet_hydra()
    return hydra, _np_tree(variables)


def _port_tiny(variables, **kw):
    model = model_builder(copy.deepcopy(TINY_RESNET_MODEL)).hydra
    return Denoiser(model, variables, device="cpu", **kw)


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _gray(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ------------------------------------------------------------------ padding

@pytest.mark.parametrize("n", [0, 1, 2, 3, 63, 64, 65, 321, 1024])
def test_next_power_of_2_matches_jax(n):
    assert tpadding.next_power_of_2(n) == jpadding.next_power_of_2(n)


def test_pad_to_power_of_2_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (2, 37, 70, 3)).astype(
        np.float32)
    ref, rh, rw = jpadding.pad_to_power_of_2(jnp.asarray(x))
    got, gh, gw = tpadding.pad_to_power_of_2(torch.from_numpy(x))
    assert (gh, gw) == (rh, rw) == (27, 58)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tpadding.remove_padding(got, gh, gw).numpy(), x)


# ------------------------------------------------------- tiny model vs JAX

TINY_CASES = {
    "pow2": (dict(pad_mode="pow2"), (2, 50, 70, 3)),
    "multiple": (dict(pad_mode="multiple", pad_multiple=16), (2, 50, 70, 3)),
    "rows": (dict(pad_multiple=16, tile_rows=48, tile_halo=8), (120, 24, 3)),
    "columns": (dict(pad_multiple=16, tile_rows=48, tile_halo=8),
                (24, 120, 3)),
    "grid": (dict(pad_multiple=16, tile_rows=48, tile_halo=8),
             (120, 120, 3)),
    "tta2": (dict(pad_multiple=8, tta=2), (2, 24, 40, 3)),
    "tta4": (dict(pad_multiple=8, tta=4), (2, 24, 40, 3)),
    "tta8": (dict(pad_multiple=8, tta=8), (2, 24, 40, 3)),
    "tta8_tiled": (dict(pad_multiple=16, tile_rows=48, tile_halo=8,
                        tta=True), (120, 24, 3)),
}


@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_tiny_denoiser_matches_jax(tiny, case):
    kw, shape = TINY_CASES[case]
    hydra, variables = tiny
    img = _images(shape, seed=len(case))
    jden = JaxDenoiser(hydra, variables, **kw)
    port = _port_tiny(variables, **kw)
    ref = np.asarray(jden.float_forward(img.astype(np.float32)))
    got = port.float_forward(img.astype(np.float32)).numpy()
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)
    out, ref_u8 = port(img), np.asarray(jden(img))
    assert out.shape == img.shape and out.dtype == np.uint8
    diff = _gray(out, ref_u8)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("case", ["multiple", "tta8_tiled"])
def test_tiny_float_forward_gradient_matches_jax(tiny, case):
    kw, shape = TINY_CASES[case]
    hydra, variables = tiny
    x = _images(shape, seed=5).astype(np.float32)
    jden = JaxDenoiser(hydra, variables, **kw)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jden.float_forward(v)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    port = _port_tiny(variables, **kw)
    (got,) = torch.autograd.grad(port.float_forward(xt).sum(), xt)
    assert got.shape == ref.shape
    assert _cosine(got.numpy(), ref) >= 0.9999


def test_tiny_variables_property_round_trips(tiny):
    _, variables = tiny
    port = _port_tiny(variables)
    back = port.variables
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ---------------------------------------------------------- flagship vs JAX

@pytest.fixture(scope="module")
def flagship():
    """(JAX float32 hydra, numpy variables, blend table, noisy 192×128
    image)."""
    jden = bid.load_model(FLAGSHIP, dtype="float32")
    cfg = load_config(bid.models[FLAGSHIP]["configuration"])
    hydra = jax_model_builder(cfg["model"]).hydra
    clean = load_evaluation_images(192)[0, :, :128]
    rng = np.random.default_rng(0)
    img = np.clip(np.round(clean + rng.normal(0, 15, clean.shape)), 0,
                  255).astype(np.uint8)
    return hydra, _np_tree(jden.variables), jden._blend.to_dict(), img


def _port_flagship(variables, blend, **kw):
    model = bidt.load_model(FLAGSHIP, device="cpu", dtype="float32").model
    return Denoiser(model, variables, blend=blend, device="cpu", **kw)


@pytest.mark.parametrize("kw,crop", [
    (dict(), (192, 128)),
    (dict(tile_rows=64), (192, 128)),
    (dict(tta=8), (96, 64)),
], ids=["untiled", "tiled", "tta8"])
def test_flagship_denoiser_matches_jax(flagship, kw, crop):
    hydra, variables, blend, img = flagship
    img = img[:crop[0], :crop[1]]
    ref = np.asarray(JaxDenoiser(hydra, variables, blend=blend, **kw)(img))
    got = _port_flagship(variables, blend, **kw)(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    diff = _gray(got, ref)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_flagship_float_forward_gradient_matches_jax(flagship):
    hydra, variables, blend, img = flagship
    x = img[:64, :64].astype(np.float32)
    jden = JaxDenoiser(hydra, variables, blend=blend)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jden.float_forward(v)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(
        _port_flagship(variables, blend).float_forward(xt).sum(), xt)
    assert _cosine(got.numpy(), ref) >= 0.9999


@pytest.mark.parametrize("blend_on", [True, False], ids=["blend", "no_blend"])
def test_flagship_low_noise_mae_matches_jax(flagship, blend_on):
    """At sigma 5 the flagship's output is further from the clean frames
    than its input (on the card too, chip_smoke.py's noise sweep). The
    same noisy frames through JAX's Denoiser and the port's, with the
    blend and without it: the MAEs agree within 0.05 gray levels, so the
    reading is the model's, not the port's. Prints the MAEs."""
    hydra, variables, blend, _ = flagship
    clean = load_evaluation_images(256)[:4]
    rng = np.random.default_rng(5)
    noisy = np.clip(np.round(clean + rng.normal(0, 5.0, clean.shape)), 0,
                    255).astype(np.uint8)
    table = blend if blend_on else None
    outs = {"jax": np.asarray(JaxDenoiser(hydra, variables,
                                          blend=table)(noisy)),
            "port": _port_flagship(variables, table)(noisy)}
    mae = {k: float(np.abs(v.astype(np.float64) - clean).mean())
           for k, v in dict(noisy=noisy, **outs).items()}
    print(f"sigma 5, blend {blend_on}: MAE {mae}")
    assert abs(mae["port"] - mae["jax"]) <= 0.05, mae


# ----------------------------------------- JAX's exactness checks, port only

@pytest.fixture(scope="module")
def tiny_port(tiny):
    return _port_tiny(tiny[1])


@pytest.mark.parametrize("shape", [(32, 32, 3), (50, 70, 3), (1, 100, 3),
                                   (2, 48, 64, 3)])
def test_denoiser_any_size_uint8(tiny_port, shape):
    img = _images(shape)
    out = tiny_port(img)
    assert out.shape == img.shape and out.dtype == np.uint8


def test_denoiser_tta_equivariance(tiny):
    variables = tiny[1]
    d = _port_tiny(variables, cast_to_uint8=False, tta=True, pad_multiple=8)
    img = _images((24, 24, 3), seed=3)
    y = d(img)
    np.testing.assert_allclose(y[:, ::-1], d(img[:, ::-1]), atol=1e-2)
    np.testing.assert_allclose(y.transpose(1, 0, 2),
                               d(img.transpose(1, 0, 2)), atol=1e-2)
    d8 = _port_tiny(variables, tta=True, pad_multiple=8)
    img2 = _images((2, 24, 40, 3), seed=4)
    out = d8(img2)
    assert out.shape == img2.shape and out.dtype == np.uint8


def test_denoiser_tta_member_subsets(tiny):
    variables = tiny[1]
    img = _images((24, 24, 3), seed=7)
    d4 = _port_tiny(variables, cast_to_uint8=False, tta=4, pad_multiple=8)
    y = d4(img)
    np.testing.assert_allclose(y[:, ::-1], d4(img[:, ::-1]), atol=1e-2)
    np.testing.assert_allclose(y[::-1], d4(img[::-1]), atol=1e-2)
    d2 = _port_tiny(variables, cast_to_uint8=False, tta=2, pad_multiple=8)
    y2 = d2(img)
    np.testing.assert_allclose(y2[::-1, ::-1], d2(img[::-1, ::-1]),
                               atol=1e-2)
    d8 = _port_tiny(variables, cast_to_uint8=False, tta=True,
                    pad_multiple=8)
    y8 = d8(img)
    assert not np.allclose(y, y8, atol=1e-4)
    assert not np.allclose(y2, y, atol=1e-4)
    with pytest.raises(ValueError, match="tta must be"):
        _port_tiny(variables, tta=3)


def test_denoiser_float_mode(tiny_port, tiny):
    d = _port_tiny(tiny[1], cast_to_uint8=False)
    out = d(np.zeros((16, 16, 3), np.uint8))
    assert out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 255.0


def test_denoiser_pad_modes_and_tiling(tiny):
    """pad 'multiple' and tiling agree with the pow2 path: the model is
    fully convolutional (interior exact, borders within the receptive
    field of the padding), and tiles equal the untiled frame exactly for
    rows, columns, both and TTA with tiling."""
    variables = tiny[1]
    img = _images((70, 90, 3))
    base = _port_tiny(variables, pad_mode="pow2")(img)
    mult = _port_tiny(variables, pad_multiple=16)(img)
    tiled = _port_tiny(variables, pad_multiple=16, tile_rows=32,
                       tile_halo=8)(img)
    r = 4
    np.testing.assert_array_equal(base[r:-r, r:-r], mult[r:-r, r:-r])
    np.testing.assert_array_equal(mult, tiled)
    for shape, kw in (((24, 120, 3), {}), ((120, 120, 3), {}),
                      ((120, 24, 3), dict(tta=True))):
        x = _images(shape, seed=shape[0] + shape[1])
        full = _port_tiny(variables, pad_multiple=16, **kw)(x)
        part = _port_tiny(variables, pad_multiple=16, tile_rows=48,
                          tile_halo=8, **kw)(x)
        np.testing.assert_array_equal(full, part)


def test_denoiser_signature_and_unported_options(tiny):
    model = model_builder(copy.deepcopy(TINY_RESNET_MODEL)).hydra
    with pytest.raises(TypeError, match="keyword-only"):
        Denoiser(model, "cpu")
    # a spatial mesh refuses TTA (JAX's ValueError), and without a process
    # group it serves nothing, a derivative included;
    # tests/test_torch_parallel.py serves it and differentiates through it
    spatial = create_mesh(data=1, spatial=2, devices=[0, 1])
    with pytest.raises(ValueError, match="tta=True is single-mesh only"):
        Denoiser(model, mesh=spatial, tta=4, device="cpu")
    with pytest.raises(ValueError, match="no spatial process group"):
        Denoiser(model, mesh=spatial, spatial_margin=8,
                 device="cpu").float_forward(
            torch.zeros((8, 8, 3), requires_grad=True))
    with pytest.raises(ValueError, match="quant=True"):
        Denoiser(model, tiny[1], quant=True, device="cpu")


def test_dispatch_and_host_copy(tiny_port):
    img = _images((3, 40, 24, 3), seed=9)
    out = tiny_port.dispatch(img)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(HostCopy(out)), tiny_port(img))
    # a torch tensor is served as it is
    np.testing.assert_array_equal(tiny_port(torch.from_numpy(img)),
                                  tiny_port(img))


# ------------------------------------------------------- weights, registry

@pytest.mark.parametrize("name", sorted(bid.models)[:3])
def test_flax_from_params_round_trips_artifacts(name):
    directory = bid.models[name]["directory"]
    tree = load_msgpack(directory + "/params.msgpack")
    if "params" not in tree:
        tree = {"params": tree}
    quant = name == "unet_laplacian_v56_highnoise"
    if quant:
        tree["quant"] = load_msgpack(directory + "/quant.msgpack")
    den = bidt.load_model(name, device="cpu", quant=quant)
    back = flax_from_params(den.model)
    assert set(back) == set(tree)
    ref = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                      err_msg=str(path))


def test_registry_searches_pretrained_path_roots(tmp_path, monkeypatch):
    import shutil
    src = bid.models["resnet_depthwise_scratch"]["directory"]
    shutil.copytree(src, tmp_path / "extra" / "my_resnet")
    (tmp_path / "extra" / "ref_only").mkdir()
    shutil.copy(os.path.join(os.path.dirname(__file__), "data",
                             "tflite_resnet_depthwise_scratch",
                             "denoiser_model.tflite"),
                tmp_path / "extra" / "ref_only" / "denoiser_model.tflite")
    (tmp_path / "extra" / "not_an_artifact").mkdir()
    monkeypatch.setenv("BID_TPU_PRETRAINED_PATH",
                       f"{tmp_path / 'missing'}:{tmp_path / 'extra'}")
    found = bidt._find_models()
    assert {"my_resnet", "ref_only", FLAGSHIP} <= set(found)
    assert "not_an_artifact" not in found
    monkeypatch.setattr(bidt, "models", found)
    img = _images((40, 33, 3))
    np.testing.assert_array_equal(
        bidt.load_model("my_resnet", device="cpu")(img),
        bidt.load_model(src, device="cpu")(img))
    # a reference-style directory: its TFLite graph serves uint8, and the
    # native-graph options raise JAX's error
    served = bidt.load_model("ref_only", device="cpu")(img)
    assert served.shape == img.shape and served.dtype == np.uint8
    with pytest.raises(ValueError, match="neither"):
        bidt.load_model("ref_only", device="cpu", tta=True)
