"""The port's model and serving path against the JAX package, on the CPU.

* a tiny random-init ``unet_laplacian`` hydra (filters 8, width
  [1, 1, 1], self-attention on) and the packaged flagship, float32: all
  three scale outputs within 0.05 gray levels of ``hydra.apply``;
* ``load_model(..., device="cpu", dtype="float32")`` against
  ``bid.load_model(..., dtype="float32")`` on noisy evaluation crops
  (a batch, and an odd 70×45 image given as a 3-D array), blend on and
  off: uint8 within 1 gray level everywhere, exact on >= 99% of pixels;
* bfloat16 serving against JAX bfloat16 (same parameters): mean |Δ| <=
  1.0 and p99 <= 3 gray levels (JAX's own bf16-vs-f32 gap on the
  flagship at 128², σ = 10, is mean 0.65, p99 2);
* the port imports no JAX while it serves the three packaged artifacts
  (v56 in int8) and calibrates, and needs an explicit CPU device without
  a card; ``quant=True`` on the flagship, which ships no
  ``quant.msgpack``, raises ``ValueError`` as in JAX.
"""

import copy
import os
import subprocess
import sys

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
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.weights import params_from_flax

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_flagship():
    """The JAX flagship served in float32, blend on (one template init
    for the whole file)."""
    return bid.load_model(FLAGSHIP, dtype="float32")


@pytest.fixture(scope="module")
def noisy_crops():
    rng = np.random.default_rng(0)
    clean = load_evaluation_images(128)
    batch = np.clip(clean[:2, :96, :96] + rng.normal(0, 10, (2, 96, 96, 3)),
                    0, 255).round().astype(np.uint8)
    odd = np.clip(clean[2, :70, :45] + rng.normal(0, 10, (70, 45, 3)),
                  0, 255).round().astype(np.uint8)
    full = np.clip(clean[:2] + rng.normal(0, 10, clean[:2].shape),
                   0, 255).round().astype(np.uint8)
    return {"batch": batch, "odd": odd, "full": full}


def _jax_denoiser(jax_den, dtype, blend):
    cfg = load_config(bid.models[FLAGSHIP]["configuration"])
    hydra = jax_model_builder(cfg["model"], dtype=dtype).hydra
    return JaxDenoiser(hydra, jax_den.variables,
                       blend=jax_den._blend if blend else None)


def _scale_outputs_match(jax_hydra, variables, torch_hydra, x):
    ref = jax_hydra.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = torch_hydra(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 3
    for r, g in zip(ref, got):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r), atol=0.05)


def test_tiny_random_unet_laplacian_matches_jax():
    cfg = load_config(bid.models[FLAGSHIP]["configuration"])["model"]
    cfg = copy.deepcopy(cfg)
    cfg["backbone"].update(filters=8, width=[1, 1, 1],
                           encoder_kernel_size=[3, 5, 3],
                           decoder_kernel_size=[3, 5, 3])
    cfg["denoiser"]["filters"] = 8
    hydra = jax_model_builder(cfg).hydra
    x = np.random.default_rng(1).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    # parameter shapes without compiling an init; values from numpy
    shapes = jax.eval_shape(
        lambda: hydra.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(x), train=False))["params"]
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = str(path[-1].key)
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape)
        return rng.normal(0, 0.3, leaf.shape)

    params = jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes)
    port = model_builder(cfg).hydra
    port.load_state_dict(params_from_flax(params), strict=True)
    _scale_outputs_match(hydra, {"params": params}, port.eval(), x)


def test_flagship_scale_outputs_match_jax(jax_flagship, noisy_crops):
    port = bidt.load_model(FLAGSHIP, device="cpu", dtype="float32")
    x = noisy_crops["batch"].astype(np.float32)
    _scale_outputs_match(jax_flagship.model, jax_flagship.variables,
                         port.model, x)


@pytest.mark.parametrize("blend", [True, False])
def test_flagship_f32_serving_matches_jax(jax_flagship, noisy_crops, blend):
    jax_den = jax_flagship if blend else _jax_denoiser(jax_flagship, None,
                                                       blend=False)
    port = bidt.load_model(FLAGSHIP, device="cpu", dtype="float32",
                           blend=None if blend else False)
    assert (port.blend is not None) == blend
    for key in ("batch", "odd"):
        img = noisy_crops[key]
        ref, got = jax_den(img), port(img)
        assert got.shape == img.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - np.asarray(ref).astype(int))
        assert diff.max() <= 1, (key, diff.max())
        assert (diff == 0).mean() >= 0.99, (key, (diff == 0).mean())


def test_flagship_bf16_serving_close_to_jax_bf16(jax_flagship, noisy_crops):
    jax_den = _jax_denoiser(jax_flagship, jnp.bfloat16, blend=True)
    port = bidt.load_model(FLAGSHIP, device="cpu")      # bf16 from pipeline
    assert port.model.dtype == torch.bfloat16
    img = noisy_crops["full"]
    diff = np.abs(port(img).astype(int) - np.asarray(jax_den(img)).astype(int))
    assert diff.mean() <= 1.0, diff.mean()
    assert np.percentile(diff, 99) <= 3, np.percentile(diff, 99)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "           'blind_image_denoising_tpu')\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import numpy as np\n"
        "import blind_image_denoising_torch as bidt\n"
        "for name, kw in (('unet_laplacian_v6_tpu_scratch', {}),\n"
        "                 ('resnet_depthwise_scratch', {}),\n"
        "                 ('unet_laplacian_v56_highnoise', {'quant': True})):\n"
        "    den = bidt.load_model(name, device='cpu', **kw)\n"
        "    out = den(np.full((40, 33, 3), 120, np.uint8))\n"
        "    assert out.shape == (40, 33, 3) and out.dtype == np.uint8\n"
        "from blind_image_denoising_torch import evaluate, serving\n"
        "from blind_image_denoising_torch.inference import blend, quantize\n"
        "quantize.calibrate(den.model,\n"
        "                   quantize.default_calibration_images(\n"
        "                       noise_stds=(0.0,), size=32))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_load_model_without_cuda_needs_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bidt.load_model(FLAGSHIP)
    with pytest.raises(RuntimeError):
        bidt.load_model(FLAGSHIP, device="cuda")


@pytest.mark.parametrize("option", [
    # a directory whose only artifact is a damaged Keras file: the import
    # fails, the TFLite fallback finds nothing, and JAX's "no loadable
    # artifact" ValueError follows (tests/test_torch_formats.py serves the
    # reference formats)
    (dict(reference_only=True), ValueError, "no loadable artifact"),
    # the flagship ships no int8 scales: ValueError, as in JAX
    (dict(quant=True), ValueError, "quant.msgpack")])
def test_unported_serving_options_raise(option, tmp_path):
    kwargs, error, match = option
    with pytest.raises(error, match=match):
        if kwargs.pop("reference_only", False):
            (tmp_path / "model_hydra.keras").write_bytes(b"")
            bidt.load_model(str(tmp_path), device="cpu")
        else:
            bidt.load_model(FLAGSHIP, device="cpu", **kwargs)


def test_registry_lists_packaged_artifacts():
    assert FLAGSHIP in bidt.models
    with pytest.raises(ValueError):
        bidt.load_model("no_such_model", device="cpu")


# ------------------------------------ the rest of the unet_laplacian family

def _seeded_variables(hydra, x):
    """params and batch_stats for ``hydra`` from numpy, shapes by
    ``jax.eval_shape`` (no compile)."""
    shapes = jax.eval_shape(
        lambda: hydra.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(x), train=False))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = str(path[-1].key)
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape)
        return rng.normal(0, 0.3, leaf.shape)

    return {k: jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), v)
        for k, v in shapes.items() if k in ("params", "batch_stats")}


def _narrow_family_matches_jax(cfg, n_scales):
    hydra = jax_model_builder(cfg).hydra
    x = np.random.default_rng(1).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    variables = _seeded_variables(hydra, x)
    ref = hydra.apply(variables, jnp.asarray(x), train=False)
    port = model_builder(cfg).hydra
    port.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == n_scales
    for r, g in zip(ref, got):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r), atol=0.05)


@pytest.mark.parametrize("name,depth", [("unet_laplacian_v3", 4),
                                        ("unet_laplacian_v4", 4),
                                        ("unet_laplacian_v5", 3)])
def test_narrowed_family_configs_match_jax(name, depth):
    """v3 (gates, strides, nearest upsample), v4 (gates, strides,
    Laplacian upsample) and v5 (strides, Laplacian upsample), decoder
    K = 1, narrowed to filters 8 and width 1, at 64²."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[name]["model"])
    cfg["backbone"].update(filters=8, width=1)
    cfg["denoiser"]["filters"] = 8
    _narrow_family_matches_jax(cfg, depth)


@pytest.mark.parametrize("option", [
    dict(use_attention_gates=True), dict(use_concat=True),
    dict(use_mix_project=True), dict(use_concat=True, use_mix_project=True),
    dict(use_bn=True), dict(use_bn=True, use_ln=False,
                            use_attention_gates=True),
    dict(use_ln=False), dict(use_bias=True), dict(use_gamma=False),
    dict(use_complex_base=True), dict(use_global_pool_information=True),
    dict(use_global_pool_information=True, use_bn=True),
    dict(space_to_depth_stem=2), dict(use_laplacian_averaging=False),
    dict(use_laplacian_averaging=False, use_laplacian=False),
    dict(dropout_rate=0.3, spatial_dropout_rate=0.2),
    dict(upsample_type="conv2d_transpose"),
    dict(upsample_type="upsample_laplacian_conv2d", activation="linear"),
    dict(downsample_type="maxpool"), dict(activation="relu"),
    dict(decoder_kernel_size=2)], ids=lambda o: "+".join(
        f"{k}={v}" for k, v in o.items()))
def test_each_builder_option_matches_jax(option):
    """Each option the port refused before, switched on alone (or with
    what it needs) on a narrowed ``unet_laplacian_v5`` (filters 8, width
    2), against ``hydra.apply`` at 64²; dropout is the identity outside
    training."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v5"]["model"])
    cfg["backbone"].update(filters=8, width=2, **option)
    cfg["denoiser"]["filters"] = 8
    _narrow_family_matches_jax(cfg, 3)


@pytest.mark.parametrize("option,match", [
    (dict(space_to_depth_stem=1), "space_to_depth_stem"),
    (dict(space_to_depth_stem=4, filters=8), "divisible"),
    (dict(use_bn="bias_free"), "string batchnorm"),
    (dict(use_soft_orthogonal_regularization=True), "mutually exclusive")])
def test_builder_refusals_are_value_errors(option, match):
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v5"]["model"])
    cfg["backbone"].update(**option)
    with pytest.raises(ValueError, match=match):
        model_builder(cfg)


@pytest.mark.parametrize("name", [n for n, _ in bidt.configs])
def test_packaged_configs_build_with_the_flax_tree(name):
    """Every packaged config builds in the port at full width, and its
    state dict has the flax tree's keys and shapes (``jax.eval_shape``,
    no compile), params and batch statistics, both ways through
    ``weights.py``."""
    from blind_image_denoising_torch.weights import flax_from_params
    key = name[:-len(".json")]
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[key]["model"])
    hydra = jax_model_builder(copy.deepcopy(cfg)).hydra
    shapes = jax.eval_shape(
        lambda: hydra.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 64, 64, 3), jnp.float32),
                           train=False))
    tree = {k: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), v)
        for k, v in shapes.items() if k in ("params", "batch_stats")}
    port = model_builder(cfg).hydra
    state = port.state_dict()
    converted = params_from_flax(tree)
    assert set(converted) == set(state)
    for k, v in converted.items():
        assert tuple(v.shape) == tuple(state[k].shape), k
    back = flax_from_params(port)

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = tuple(np.shape(v))
        return out

    assert flat(back) == flat(tree)
