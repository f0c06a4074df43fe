"""The formats tied to JAX and TensorFlow, read by the port, against the
JAX package, on the CPU: the TFLite executor (``inference/tflite.py``),
the v5.6 ``.keras`` import (``inference/import_v56.py``) and
``load_model``'s reference-style branches. The artifacts JAX writes
through TensorFlow (SavedModel, the HydraLayer archive) are held in
``tests/test_torch_tf_formats.py``, the ``torch.export`` program in
``tests/test_torch_export_program.py``.

* TFLite, on the committed fixture (``write_tflite_fixture.py``: JAX's
  ``serialize_tflite`` of the packaged ``resnet_depthwise_scratch``):
  the port's parse equals JAX's (operators, inputs, outputs, options,
  dequantized constants bit for bit); its output matches JAX's executor
  within atol 1e-2 on [0, 255] floats, and as uint8 within one gray
  level, ≥ 99% equal. JAX's own ``load_tflite_denoiser`` raises on the
  fixture (its CONV_2D takes no groups, and the resnet's last 1×1 of
  every block has 2), so the reference is JAX's executor with that one
  operator grouped, in this file. ``load_model`` of the fixture's
  directory serves uint8 as far from the native resnet's float32
  forward as JAX's executor is from JAX's (the int8 weights), within one
  gray level of JAX's largest gap and 0.01 of its mean. JAX's bar for dynamic-range weights
  (``tests/test_inference.py``, 2 gray levels on a 4-filter resnet)
  does not hold for the packaged resnet, in JAX either.
* TFLite, on an op-coverage flatbuffer the test converts with
  ``tf.lite.TFLiteConverter`` from a ``tf.function`` that uses every
  operator of JAX's dispatch table that the converter keeps: the port
  against JAX's executor, float within 1e-4 of the output's range.
* ``.keras``: an archive in the reference's layout (a zip of
  ``model.weights.h5`` written with ``h5py`` from the packaged v5.6
  params under the names ``build_pretrained_v56`` reads) served by the
  port's ``load_model(dir, device="cpu")`` and JAX's, uint8 within one
  gray level, ≥ 99% equal (``test_artifact_f32_serving_matches_jax``'s
  bar); ``tta`` / ``blend`` / ``dtype`` / ``quant`` raise JAX's errors,
  message for message; a damaged archive falls through to the TFLite
  graph, and with ``tta`` raises.
* Import hygiene: a subprocess imports the port, serves the three
  packaged artifacts and the TFLite fixture and runs a ``torch.export``
  program with ``jax``, ``flax``,
  ``orbax``, ``msgpack``, ``tensorstore``, ``h5py``, ``tensorflow``,
  ``tf_keras``, ``flatbuffers`` and ``blind_image_denoising_tpu``
  blocked.
"""

import copy
import io
import os
import shutil
import subprocess
import sys
import zipfile
from collections import Counter
from pathlib import Path

import flax.serialization as fser
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import tensorflow as tf
from jax import lax

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.images import load_evaluation_images
from blind_image_denoising_tpu.inference import tflite as jax_tflite
from blind_image_denoising_torch.inference import import_v56, tflite
from blind_image_denoising_torch.inference.denoiser import as_uint8
from blind_image_denoising_torch.inference.export import (
    TORCH_EXPORT_FILE, serialize_torch_export)
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.weights import load_msgpack, params_from_flax

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "tflite_resnet_depthwise_scratch"
RESNET = "resnet_depthwise_scratch"
V56 = "unet_laplacian_v56_highnoise"
FLAGSHIP = "unet_laplacian_v6_tpu_scratch"


def _noisy(size, sigma, n=3, seed=0):
    clean = load_evaluation_images(size)[:n]
    rng = np.random.default_rng(seed)
    return np.clip(np.round(clean + rng.normal(0, sigma, clean.shape)),
                   0, 255).astype(np.uint8)


def _gray_diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _assert_uint8_close(got, ref, max_diff=1, equal_share=0.99):
    diff = _gray_diff(got, ref)
    assert diff.max() <= max_diff, diff.max()
    assert (diff == 0).mean() >= equal_share, (diff == 0).mean()


# ---------------------------------------------------------------- TFLite

class _GroupedExecutor(jax_tflite.TFLiteExecutor):
    """JAX's executor with CONV_2D grouped where its weights hold fewer
    input channels than x (the one operator of the fixture that JAX's
    executor does not take); every other operator is JAX's."""

    def _execute(self, op, env):
        if op.name != "CONV_2D":
            return super()._execute(op, env)
        x, w = jnp.asarray(env[op.inputs[0]]), jnp.asarray(env[op.inputs[1]])
        o = op.options
        y = lax.conv_general_dilated(
            x, jnp.transpose(w, (1, 2, 3, 0)), window_strides=o["stride"],
            padding="SAME" if o["padding"] == 0 else "VALID",
            rhs_dilation=o["dilation"],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=x.shape[-1] // w.shape[-1])
        if len(op.inputs) > 2 and op.inputs[2] != -1:
            y = y + jnp.asarray(env[op.inputs[2]])
        env[op.outputs[0]] = jax_tflite._apply_fused_activation(
            y, o.get("activation"))


def _jax_run(path, executor=jax_tflite.TFLiteExecutor):
    ex = executor(str(path))
    return jax.jit(lambda x: ex(x))


def _assert_parse_equals_jax(path):
    ops, consts, ins, outs, _ = tflite.parse_tflite(path.read_bytes())
    jops, jconsts, jins, jouts, _ = jax_tflite._parse(str(path))
    assert (ins, outs) == (jins, jouts) and len(ops) == len(jops)
    for a, b in zip(ops, jops):
        assert (a.name, a.inputs, a.outputs) == (b.name, b.inputs, b.outputs)
        b_opts = {k: v for k, v in b.options.items()
                  if k not in ("depth_multiplier", "raw")}
        assert a.options == b_opts, a.name
    assert set(consts) == set(jconsts)
    for t, v in jconsts.items():
        assert consts[t].dtype == v.dtype and np.array_equal(consts[t], v), t
    return ops


def test_fixture_parse_and_output_match_jax():
    path = FIXTURE / tflite.TFLITE_FILE
    ops = _assert_parse_equals_jax(path)
    assert {o.name for o in ops} >= {"CONV_2D", "DEPTHWISE_CONV_2D",
                                     "BROADCAST_TO", "SHAPE", "PAD"}
    with pytest.raises(ValueError, match="feature_group_count"):
        _jax_run(path)(np.zeros((1, 32, 32, 3), np.uint8))
    ref_fn = _jax_run(path, _GroupedExecutor)
    port_fn = tflite.load_tflite_denoiser(str(path), device="cpu")
    rng = np.random.default_rng(0)
    for shape in ((2, 64, 96, 3), (1, 321, 481, 3)):
        x = rng.integers(0, 256, shape).astype(np.uint8)
        ref, got = np.asarray(ref_fn(x)), port_fn(x)
        assert got.shape == ref.shape == shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-2)
        _assert_uint8_close(as_uint8(got), as_uint8(ref))


def test_fixture_serves_as_far_from_the_native_resnet_as_jax():
    img = _noisy(96, 25.0)
    den = bidt.load_model(FIXTURE, device="cpu")
    got = den(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    # the graph is the hydra's forward with no padding of its own, its
    # weights int8: held against the native resnet's forward on the
    # same images, the port's gap against JAX's
    model = bidt.load_model(RESNET, device="cpu", dtype="float32").model
    with torch.no_grad():
        native = model(torch.from_numpy(img).float().permute(0, 3, 1, 2))[0]
    port_gap = _gray_diff(got, as_uint8(native.permute(0, 2, 3, 1).numpy()))
    jden = bid.load_model(RESNET, dtype="float32")
    jax_gap = _gray_diff(
        as_uint8(np.asarray(_jax_run(FIXTURE / tflite.TFLITE_FILE,
                                     _GroupedExecutor)(img))),
        as_uint8(np.asarray(jden.model.apply(
            jden.variables, img.astype(np.float32), train=False)[0])))
    assert port_gap.max() <= jax_gap.max() + 1
    assert abs(port_gap.mean() - jax_gap.mean()) <= 0.01
    # one image, and float input rounded and clipped as the Denoiser does
    one = den(img[0].astype(np.float32) + 0.3)
    np.testing.assert_array_equal(one, got[0])
    np.testing.assert_array_equal(
        den(np.full((8, 8, 3), 300.0)), den(np.full((8, 8, 3), 255, np.uint8)))


def _coverage_function():
    rng = np.random.default_rng(1)
    w1 = tf.constant(rng.normal(0, 0.3, (3, 3, 4, 8)).astype(np.float32))
    b1 = tf.constant(rng.normal(0, 0.1, (8,)).astype(np.float32))
    dw = tf.constant(rng.normal(0, 0.3, (3, 3, 8, 1)).astype(np.float32))

    @tf.function(input_signature=[
        tf.TensorSpec([None, None, None, 4], tf.float32)])
    def f(x):
        s = tf.shape(x)                                   # SHAPE
        b, h, w = s[0], s[1], s[2]                        # STRIDED_SLICE
        y = tf.nn.relu(tf.nn.conv2d(x, w1, 1, "SAME") + b1)     # CONV_2D
        y = tf.nn.depthwise_conv2d(y, dw, [1, 1, 1, 1], "SAME")
        y = tf.nn.leaky_relu(y, 0.2)                      # LEAKY_RELU
        m = tf.reduce_mean(y, axis=[1, 2], keepdims=True)         # MEAN
        v = tf.reduce_mean(tf.math.squared_difference(y, m), [1, 2],
                           keepdims=True)
        y = (y - m) * tf.math.rsqrt(v + 1e-3)             # SUB MUL RSQRT
        y = tf.maximum(tf.minimum(y, 3.0), -3.0)          # MIN / MAX
        y = tf.nn.gelu(y, approximate=False) + tf.tanh(y)         # GELU
        y = y / (tf.abs(y) + 1.0)                         # DIV ABS
        y = y + tf.exp(-tf.abs(y)) + tf.math.log(tf.abs(y) + 1.0)
        y = y + tf.sqrt(tf.abs(y)) + tf.floor(y) - tf.math.ceil(y)
        y = y + tf.round(2.5 * y) + tf.pow(tf.abs(y) + 1.0, y)
        y = y + tf.nn.relu(-y)                            # NEG RELU
        tokens = tf.reshape(y, tf.stack([b, h * w, 8]))   # RESHAPE PACK
        att = tf.nn.softmax(tf.matmul(tokens, tokens, transpose_b=True))
        y = tf.reshape(tf.matmul(att, tokens), tf.shape(y))   # BATCH_MATMUL
        half = tf.cast(h // 2, tf.float32)                # FLOOR_DIV CAST
        fill = tf.fill(tf.stack([b, h, w, 1]), half)      # FILL
        y = tf.concat([y, fill], axis=-1)                 # CONCATENATION
        y = tf.pad(y, [[0, 0], [1, 1], [2, 2], [0, 0]])   # PAD
        y = tf.slice(y, [0, 1, 2, 0], tf.stack([-1, h, w, -1]))   # SLICE
        up = tf.image.resize(y, tf.stack([2 * h, 2 * w]))  # RESIZE (hpc)
        legacy = tf.compat.v1.image.resize_bilinear(y, tf.stack([2 * h,
                                                                 2 * w]))
        y = up + legacy + tf.broadcast_to(b1[:1], tf.shape(up))
        return tf.transpose(y[:, ::2, ::-1, :], [0, 2, 1, 3])   # TRANSPOSE
    return f


@pytest.fixture(scope="module")
def coverage_flatbuffer(tmp_path_factory):
    f = _coverage_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions(
        [f.get_concrete_function()], f)
    path = tmp_path_factory.mktemp("tflite") / "coverage.tflite"
    path.write_bytes(converter.convert())
    return path


def test_op_coverage_flatbuffer_matches_jax(coverage_flatbuffer):
    ops = _assert_parse_equals_jax(coverage_flatbuffer)
    names = Counter(o.name for o in ops)
    fixture = {o.name for o in tflite.parse_tflite(
        (FIXTURE / tflite.TFLITE_FILE).read_bytes())[0]}
    covered = set(names) | fixture
    dispatch = set(tflite._BUILTINS.values()) - {"CUSTOM"}
    assert dispatch - covered <= {"RELU"}, sorted(dispatch - covered)
    resizes = [o.options["half_pixel_centers"] for o in ops
               if o.name == "RESIZE_BILINEAR"]
    assert sorted(resizes) == [False, True]
    ref_fn = _jax_run(coverage_flatbuffer)
    port = tflite.TFLiteExecutor(str(coverage_flatbuffer), device="cpu")
    rng = np.random.default_rng(2)
    for shape in ((1, 6, 10, 4), (2, 8, 4, 4)):
        x = rng.normal(0, 1, shape).astype(np.float32)
        ref = np.asarray(ref_fn(x))
        got = port(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * float(np.ptp(ref)))


def test_tflite_needs_a_flatbuffer(tmp_path):
    path = tmp_path / tflite.TFLITE_FILE
    path.write_bytes(b"not a flatbuffer")
    with pytest.raises(ValueError, match="TFL3"):
        tflite.TFLiteExecutor(str(path), device="cpu")


# ---------------------------------------------------------------- .keras

_PREFIX = "_layer_checkpoint_dependencies/"


def _write_v56_keras(params, path):
    """The packaged v5.6 params as the reference's ``model_hydra.keras``:
    a zip of ``model.weights.h5`` whose datasets sit under the layer
    names ``build_pretrained_v56`` reads, in the Keras layouts."""
    bb = "functional_1/functional/"
    weights = {}

    def cnb(i):
        return "conv_next_block" + ("" if i == 0 else f"_{i}")

    def csa(i):
        return "convolutional_self_attention" + ("" if i == 0 else f"_{i}")

    for key, name in (("stem", "conv2d"), ("down_0", "conv2d_2"),
                      ("down_1", "conv2d_4"), ("up_1", "conv2d_6"),
                      ("up_0", "conv2d_8")):
        weights[bb + name] = params[key]
    for prefix, d, base in (("enc", 0, 0), ("enc", 1, 6), ("dec", 1, 12),
                            ("dec", 0, 18)):
        for i in range(3):
            p, name = params[f"{prefix}_{d}_{i}"], bb + cnb(base + 2 * i)
            weights[f"{name}/conv_1"] = np.transpose(p["conv_1"],
                                                     (0, 1, 3, 2))
            weights[f"{name}/conv_2"] = p["conv_2"]
            weights[f"{name}/conv_3"] = p["conv_3"]
            weights[f"{name}/ln"] = p["ln"]["scale"]
            weights[f"{name}/gamma"] = p["gamma"]["w"].reshape(1, 1, 1, -1)
    for i in range(3):
        p, name = params[f"attn_{i}"], bb + csa(2 * i)
        for k in ("query_conv", "key_conv", "value_conv", "output_fn"):
            weights[f"{name}/{k}"] = p[k]
        for k in ("ln_0", "ln_1"):
            weights[f"{name}/{k}"] = p[k]["scale"]
        weights[f"{name}/gamma"] = p["gamma"]["w"].reshape(1, 1, 1, -1)
    for i, fn, ln in ((0, "functional_3", "layer_normalization"),
                      (1, "functional_5", "layer_normalization_2"),
                      (2, "functional_7", "layer_normalization_4")):
        weights[bb + ln] = params[f"out_ln_{i}"]["scale"]
        weights[f"{fn}/conv2d"] = params[f"head_{i}_conv_0"]
        weights[f"{fn}/conv2d_2"] = params[f"head_{i}_conv_1"]
    buf = io.BytesIO()
    with h5py.File(buf, "w") as f:
        for name, value in weights.items():
            parts = name.split("/")
            h5_name = _PREFIX + ("/" + _PREFIX).join(parts) + "/vars/0"
            f.create_dataset(h5_name, data=np.asarray(value, np.float32))
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("model.weights.h5", buf.getvalue())


@pytest.fixture(scope="module")
def keras_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("keras")
    params = fser.msgpack_restore(
        (Path(bid.models[V56]["directory"]) / "params.msgpack")
        .read_bytes())
    params = params.get("params", params)
    _write_v56_keras(params, root / "model_hydra.keras")
    return root


def test_keras_import_serves_as_jax(keras_dir):
    img = _noisy(96, 60.0)
    ref = bid.load_model(str(keras_dir))(img)
    den = bidt.load_model(keras_dir, device="cpu")
    assert den.model.dtype is None
    got = den(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    _assert_uint8_close(got, ref)
    # the imported weights are the packaged artifact's, bit for bit
    packaged = params_from_flax(load_msgpack(
        Path(bid.models[V56]["directory"]) / "params.msgpack"))
    state = den.model.state_dict()
    assert set(state) == set(packaged)
    for k, v in packaged.items():
        assert torch.equal(state[k], v), k
    assert bidt.load_model(keras_dir, device="cpu",
                           dtype="bfloat16").model.dtype == torch.bfloat16


def _both_raise(path, **kw):
    """The port's and JAX's load_model raise the same ValueError."""
    with pytest.raises(ValueError) as port:
        bidt.load_model(str(path), device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        bid.load_model(str(path), **kw)
    assert str(port.value) == str(ref.value)
    return str(port.value)


@pytest.mark.parametrize("kw,match", [
    (dict(tta=True), "tta=True needs"), (dict(blend=True), "blend needs"),
    (dict(dtype="bfloat16"), "dtype='bfloat16' needs"),
    (dict(quant=True), "quant=True needs")])
def test_reference_directory_errors_match_jax(tmp_path, kw, match):
    shutil.copy(FIXTURE / tflite.TFLITE_FILE, tmp_path)
    assert match in _both_raise(tmp_path, **kw)


def test_a_damaged_keras_archive_falls_through_to_tflite(tmp_path,
                                                         keras_dir):
    (tmp_path / "model_hydra.keras").write_bytes(b"not a zip")
    assert "failed" in _both_raise(tmp_path, tta=True)
    shutil.copy(FIXTURE / tflite.TFLITE_FILE, tmp_path)
    img = _noisy(64, 25.0, n=1)
    np.testing.assert_array_equal(
        bidt.load_model(tmp_path, device="cpu")(img),
        bidt.load_model(FIXTURE, device="cpu")(img))
    # an archive without one of the model's layers is an import error
    with zipfile.ZipFile(keras_dir / "model_hydra.keras") as z:
        data = z.read("model.weights.h5")
    buf = io.BytesIO()
    with h5py.File(io.BytesIO(data), "r") as src, \
            h5py.File(buf, "w") as dst:
        names = []
        src.visititems(lambda n, o: names.append(n)
                       if isinstance(o, h5py.Dataset) else None)
        for n in names[1:]:
            dst.create_dataset(n, data=src[n][()])
    partial = tmp_path / "partial.keras"
    with zipfile.ZipFile(partial, "w") as z:
        z.writestr("model.weights.h5", buf.getvalue())
    with pytest.raises(import_v56.KerasImportError, match="no weight"):
        import_v56.build_pretrained_v56(str(partial))


def test_no_loadable_artifact(tmp_path):
    (tmp_path / "saved_model.txt").write_text("")
    _both_raise(tmp_path)


# ------------------------------------------------------------- hygiene

def test_formats_serve_without_jax_or_tf(tmp_path):
    # a narrow flagship's program (depth 2, filters 8: K1 and K2 nodes)
    mc = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"]["model"])
    mc["backbone"].update(depth=2, filters=8, width=[1, 1],
                          encoder_kernel_size=[3, 5],
                          decoder_kernel_size=[3, 5])
    blob, _ = serialize_torch_export(model_builder(mc).hydra,
                                     (1, 64, 64, 3))
    root = tmp_path
    (root / TORCH_EXPORT_FILE).write_bytes(blob)
    # torch.export.load imports torch._dynamo, whose import probes for
    # other libraries with find_spec (and imports none): that happens
    # before the blocker goes in
    code = f"""
import sys
import torch._dynamo
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "msgpack", "tensorstore",
           "h5py", "tensorflow", "tf_keras", "flatbuffers",
           "blind_image_denoising_tpu")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import numpy as np
import blind_image_denoising_torch as bidt
from blind_image_denoising_torch.inference.export import load_torch_export
img = np.full((40, 33, 3), 120, np.uint8)
for name, kw in (("unet_laplacian_v6_tpu_scratch", {{}}),
                 ("resnet_depthwise_scratch", {{}}),
                 ("unet_laplacian_v56_highnoise", {{"quant": True}}),
                 ({str(FIXTURE)!r}, {{}})):
    out = bidt.load_model(name, device="cpu", **kw)(img)
    assert out.shape == img.shape and out.dtype == np.uint8
y = load_torch_export({str(root)!r}, device="cpu")(
    np.zeros((1, 64, 64, 3), np.float32))
assert tuple(y.shape) == (1, 64, 64, 3)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
