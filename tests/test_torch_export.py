"""Train → export → serve through the port, against the JAX package, on
the CPU.

* The msgpack writer (``weights.msgpack_serialize``): its bytes equal
  ``flax.serialization.to_bytes`` on a tree of float / int / bool arrays,
  0-d arrays and numpy scalars in the given key order, and
  ``msgpack_serialize`` on the same tree with its keys sorted (flax's
  call sorts them); ``flax.serialization.msgpack_restore`` and
  ``from_bytes`` read it back to equal arrays, dtypes and shapes.
* int8 through the ConvNext units: ``calibrate`` on a seeded narrow
  ``unet_laplacian`` hydra (the flagship config at depth 3, filters 8,
  attention at level 2; a converted flax init) returns JAX's site tree
  (every ConvBlock, the three convs of every unit, the attention's four
  1×1s) with scales within ``calibrate_fused``'s rtol 1e-2; its int8
  serving against JAX's ``quant=True`` within the v5.6 int8 test's bars:
  mean ≤ 1.0 gray level, p99 no larger than JAX's own int8 path moves
  when one LayerNorm scale is multiplied by (1 + 1e-6) (at least 3).
* Export round trip: a narrow flagship config trained two steps by the
  port's ``train_loop`` (EMA 0.5) and exported by the port's
  ``export_model`` (``quantize=True``, ``test_model=True``) loads in
  JAX's ``load_model`` and in the port's, and both serve it alike in
  float32, to the bars of the flagship's f32 parity tests (uint8 within
  one gray level, ≥ 99% equal); ``params.msgpack`` holds the checkpoint's
  EMA tensors bit for bit (the raw params with ``use_ema=False``); JAX
  reads ``quant.msgpack`` back to the arrays the port calibrated, which
  match JAX's ``calibrate`` on the exported weights and the same images
  within rtol 1e-2, and both packages serve ``quant=True`` from it, the
  port within the int8 bars above of JAX. A BatchNorm resnet run exports
  its checkpoint's buffers as ``batch_stats`` bit for bit, and JAX serves
  that artifact as the port does. A directory without a checkpoint
  raises; ``to_torch_export`` (and the CLI's ``--to-torch-export``)
  writes ``denoiser.pt2``, whose program equals the artifact's eager
  float32 forward within 1e-5; StableHLO raises naming
  ``to_torch_export``, TFLite / Keras raise naming the missing
  converter; the
  ``export`` CLI runs with ``--device cpu``.
* The ``build`` CLI writes the ``model_structure.json`` JAX's ``build``
  writes (same tree of param shapes) for the flagship and a resnet
  config, and a ``params.msgpack`` that JAX's ``from_bytes`` takes.
"""

import copy
import json
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu import build as jax_build
from blind_image_denoising_tpu.images import load_evaluation_images
from blind_image_denoising_tpu.inference import quantize as jquantize
from blind_image_denoising_tpu.inference.denoiser import (
    Denoiser as JaxDenoiser)
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_torch import build as build_cli
from blind_image_denoising_torch import export as export_cli
from blind_image_denoising_torch.inference import quantize as tquantize
from blind_image_denoising_torch.inference.denoiser import Denoiser
from blind_image_denoising_torch.inference.export import (
    TORCH_EXPORT_FILE, export_model, load_torch_export, save_params_artifact)
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.training import train_loop as loop_module
from blind_image_denoising_torch.training.checkpoint import CheckpointManager
from blind_image_denoising_torch.weights import (
    attach_quant_scales, load_msgpack, msgpack_restore, msgpack_serialize,
    params_from_flax)

CONFIG = "unet_laplacian_v6_tpu"
RESNET = "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _gray_diff(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _noisy(size, sigma, n=2, seed=0):
    clean = load_evaluation_images(size)[:n]
    rng = np.random.default_rng(seed)
    return np.clip(np.round(clean + rng.normal(0, sigma, clean.shape)),
                   0, 255).astype(np.uint8)


# ---------------------------------------------------------------- msgpack

def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 1, 8)).astype(
                np.float32), "bias": np.zeros((8,), np.float32)},
            "ln": {"scale": rng.uniform(size=(17,)).astype(np.float32)},
            "big": {"kernel": rng.normal(size=(70000,)).astype(np.float32)},
            "empty": np.zeros((0, 4), np.float32)},
        "batch_stats": {"bn": {"mean": rng.normal(size=(5,)).astype(
            np.float32), "var": np.ones((5,), np.float64)}},
        "quant": {"a": {"in_scale": np.asarray(0.25, np.float32)},
                  "b_scale": np.float32(3.5)},
        "other": {"i8": np.arange(-5, 5, dtype=np.int8),
                  "i64": np.arange(300, dtype=np.int64).reshape(3, 100),
                  "flags": np.array([True, False]),
                  "half": np.ones((2,), np.float16)},
    }


def _sorted(tree):
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


@pytest.mark.parametrize("flax_call", ["to_bytes", "msgpack_serialize"])
def test_msgpack_writer_bytes_equal_flax(flax_call):
    tree = _tree()
    if flax_call == "to_bytes":
        assert msgpack_serialize(tree) == fser.to_bytes(tree)
    else:
        assert msgpack_serialize(_sorted(tree)) == fser.msgpack_serialize(
            tree)


def test_msgpack_writer_reads_back_in_flax():
    tree = _tree()
    data = msgpack_serialize(tree)
    for back in (fser.msgpack_restore(data), fser.from_bytes(tree, data),
                 msgpack_restore(data)):
        flat, ref = _flat(back), _flat(tree)
        assert set(flat) == set(ref)
        for k, v in ref.items():
            assert flat[k].dtype == v.dtype and flat[k].shape == v.shape, k
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    with pytest.raises(TypeError):
        msgpack_serialize({"a": object()})


# ------------------------------------------- int8 through the ConvNext units

def _narrow_flagship(depth=3):
    mc = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG]["model"])
    mc["backbone"].update(depth=depth, filters=8, width=[1] * depth,
                          encoder_kernel_size=[3, 5, 5][:depth],
                          decoder_kernel_size=[3, 5, 5][:depth])
    return mc


@pytest.fixture(scope="module")
def narrow_flagship():
    mc = _narrow_flagship()
    jhydra = jax_model_builder(copy.deepcopy(mc)).hydra
    params = jax.tree_util.tree_map(np.asarray, jhydra.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 64, 64, 3)),
        train=False)["params"])
    images = _noisy(64, 30.0, n=4, seed=3).astype(np.float32)
    variables = jquantize.calibrate(jhydra, {"params": params}, images,
                                    batch_size=2)
    port = model_builder(copy.deepcopy(mc)).hydra
    port.load_state_dict(params_from_flax(params), strict=True)
    got = tquantize.calibrate(port, images, batch_size=2)
    return jhydra, variables, port, got


def test_calibrate_through_convnext_units_matches_jax(narrow_flagship):
    _, variables, _, got = narrow_flagship
    ref, flat = _flat(variables["quant"]), _flat(got)
    assert set(flat) == set(ref)
    for unit in ("encoder_0_0", "decoder_1_0"):
        for conv in ("conv_1", "conv_2", "conv_3"):
            assert f"backbone/{unit}/{conv}/in_scale" in ref
    assert "backbone/encoder_2_0_attn/query_conv/in_scale" in ref
    for k, v in ref.items():
        assert float(flat[k]) == pytest.approx(float(v), rel=1e-2), k


def test_int8_through_convnext_units_close_to_jax(narrow_flagship,
                                                  monkeypatch):
    jhydra, variables, port, got = narrow_flagship
    img = _noisy(64, 20.0, seed=4)
    ref = np.asarray(JaxDenoiser(jhydra, variables, quant=True)(img))
    # JAX against itself with one LayerNorm scale moved by 1e-6 relative
    params = dict(variables["params"])
    backbone = dict(params["backbone"])
    unit = dict(backbone["encoder_1_0"])
    unit["conv_1"] = dict(unit["conv_1"], ln={
        "scale": unit["conv_1"]["ln"]["scale"] * (1 + 1e-6)})
    backbone["encoder_1_0"] = unit
    params["backbone"] = backbone
    own = _gray_diff(JaxDenoiser(jhydra, dict(variables, params=params),
                                 quant=True)(img), ref)

    def no_k1(*args, **kwargs):
        raise AssertionError("K1 ran on the int8 route")
    from blind_image_denoising_torch.layers import convnext as convnext_mod
    monkeypatch.setattr(convnext_mod, "convnext_block", no_k1)
    assert attach_quant_scales(port, got) == len(_flat(got))
    diff = _gray_diff(Denoiser(port, quant=True, device="cpu")(img), ref)
    print(f"narrow v6 int8 vs JAX: mean {diff.mean():.3f}, p99 "
          f"{np.percentile(diff, 99)}; JAX vs itself moved by 1e-6: mean "
          f"{own.mean():.3f}, p99 {np.percentile(own, 99)}")
    assert diff.mean() <= 1.0, diff.mean()
    assert np.percentile(diff, 99) <= max(3.0, np.percentile(own, 99))


# ---------------------------------------------------------------- export

def _pipeline(model, **train):
    """A narrow config on the synthetic stream: 32² crops, batches of 2
    in 2 micro-batches, float32, two steps."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[
        RESNET if model == "resnet" else CONFIG])
    if model == "resnet":
        cfg["model"]["backbone"].update(filters=8, no_layers=2,
                                        block_filters=[8, 32, 8])
    else:
        cfg["model"] = _narrow_flagship(depth=2)
    cfg["train"].update(dict(
        dict(total_steps=2, checkpoint_every=-1, visualization_every=-1,
             log_every=1, gpu_batches_per_step=2, use_test_images=False,
             ema=0.5), **train))
    cfg["dataset"].update(inputs=[], input_shape=[32, 32, 3], batch_size=2,
                          no_crops_per_image=1)
    cfg["tpu"] = {"compute_dtype": "float32"}
    return cfg


def _calibration_images():
    return tquantize.default_calibration_images(size=32, seed=2)


@pytest.fixture(scope="module")
def flagship_export(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    cfg = _pipeline("flagship")
    loop_module.train_loop(cfg, root / "run", device="cpu")
    out = export_model(cfg, root / "run", root / "artifact", quantize=True,
                       calibration_images=_calibration_images(),
                       test_model=True, device="cpu")
    return cfg, root, out


def test_export_serves_alike_in_jax_and_port(flagship_export):
    _, _, out = flagship_export
    img = _noisy(64, 25.0, seed=6)
    ref = np.asarray(bid.load_model(out)(img))
    got = bidt.load_model(out, device="cpu")(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    diff = _gray_diff(got, ref)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_narrow_v4_export_serves_alike_in_jax_and_port(tmp_path):
    """``unet_laplacian_v4`` (attention gates, strided downsample,
    Laplacian upsample, decoder K = 1) narrowed to filters 8 and width 1,
    trained two steps by the port's ``train_loop`` and exported by its
    ``export_model``: JAX's ``load_model`` serves the artifact as the
    port's does, in float32, within one gray level on >= 99% equal."""
    cfg = _pipeline("flagship")
    cfg["model"] = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v4"][
        "model"])
    cfg["model"]["backbone"].update(filters=8, width=1)
    cfg["model"]["denoiser"]["filters"] = 8
    # depth 4: the SSIM of the 1/8 scale needs crops of 64²
    cfg["dataset"]["input_shape"] = [64, 64, 3]
    loop_module.train_loop(cfg, tmp_path / "run", device="cpu")
    out = export_model(cfg, tmp_path / "run", tmp_path / "artifact",
                       device="cpu")
    img = _noisy(64, 25.0, seed=7)
    ref = np.asarray(bid.load_model(out)(img))
    got = bidt.load_model(out, device="cpu")(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    diff = _gray_diff(got, ref)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


@pytest.mark.parametrize("use_ema", [True, False])
def test_export_writes_the_checkpoint_weights(flagship_export, tmp_path,
                                              use_ema):
    cfg, root, out = flagship_export
    if not use_ema:
        out = export_model(cfg, root / "run", tmp_path, use_ema=False,
                           device="cpu")
    manager = CheckpointManager(str(root / "run"))
    ckpt = manager.read(manager.latest_step())
    written = params_from_flax(load_msgpack(f"{out}/params.msgpack"))
    source = ckpt["ema_params"] if use_ema else ckpt["model"]
    assert set(written) == set(ckpt["ema_params"])
    for k, v in written.items():
        assert torch.equal(v, source[k]), k
    assert any(not torch.equal(ckpt["ema_params"][k], ckpt["model"][k])
               for k in written)
    assert json.loads((Path(out) / "pipeline.json").read_text()) == cfg


def test_export_quant_reads_back_and_serves_in_jax(flagship_export):
    _, _, out = flagship_export
    data = open(f"{out}/quant.msgpack", "rb").read()
    got = _flat(msgpack_restore(data))
    back = _flat(fser.msgpack_restore(data))
    assert set(back) == set(got) and len(got) == 17
    for k, v in got.items():
        assert back[k].dtype == np.float32 and back[k].shape == ()
        assert np.array_equal(back[k], v), k
    # JAX's calibration of the exported weights on the same images
    jden = bid.load_model(out, dtype="float32")
    ref = _flat(jquantize.calibrate(jden.model, jden.variables,
                                    _calibration_images())["quant"])
    assert set(ref) == set(got)
    for k, v in ref.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-2), k
    img = _noisy(64, 20.0, seed=7)
    jint8 = bid.load_model(out, quant=True)
    ref = np.asarray(jint8(img))
    diff = _gray_diff(bidt.load_model(out, device="cpu", quant=True)(img),
                      ref)
    print(f"exported narrow v6 int8 vs JAX: mean {diff.mean():.3f}, p99 "
          f"{np.percentile(diff, 99)}")
    assert diff.mean() <= 1.0, diff.mean()
    assert np.percentile(diff, 99) <= 3.0


def test_resnet_export_batch_stats_bit_exact(tmp_path):
    cfg = _pipeline("resnet")
    loop_module.train_loop(cfg, tmp_path / "run", device="cpu")
    out = export_model(cfg, tmp_path / "run", tmp_path / "artifact",
                       device="cpu")
    manager = CheckpointManager(str(tmp_path / "run"))
    ckpt = manager.read(manager.latest_step())
    tree = load_msgpack(f"{out}/params.msgpack")
    assert set(tree) == {"params", "batch_stats"}
    stats = params_from_flax({"params": {},
                              "batch_stats": tree["batch_stats"]})
    buffers = {k for k, v in ckpt["model"].items()
               if k.rsplit(".", 1)[-1] in ("mean", "var")}
    assert set(stats) == buffers and buffers
    for k, v in stats.items():
        assert torch.equal(v, ckpt["model"][k]), k
    # the running statistics moved off their initial values
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in
               stats.items() if k.endswith(".mean"))
    img = _noisy(64, 25.0, seed=8)
    ref = np.asarray(bid.load_model(out)(img))
    diff = _gray_diff(bidt.load_model(out, device="cpu")(img), ref)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


def test_save_params_artifact_loads_in_jax(flagship_export, tmp_path):
    cfg, _, out = flagship_export
    model = bidt.load_model(out, device="cpu").model
    path = save_params_artifact(model, cfg, tmp_path)
    assert set(load_msgpack(f"{path}/params.msgpack")) == {"params"}
    img = _noisy(32, 25.0, seed=9)
    diff = _gray_diff(bid.load_model(path)(img), bid.load_model(out)(img))
    assert diff.max() == 0


def test_export_without_checkpoint_raises(tmp_path):
    with pytest.raises(ValueError, match="no checkpoint"):
        export_model(_pipeline("flagship"), tmp_path / "empty",
                     tmp_path / "out", device="cpu")


@pytest.mark.parametrize("flag,match", [
    pytest.param("to_stablehlo", "to_torch_export", id="to_stablehlo"),
    pytest.param("to_tflite", "no converter", id="to_tflite"),
    pytest.param("to_keras", "no converter", id="to_keras")])
def test_export_of_jax_formats_raises(flagship_export, tmp_path, flag,
                                      match):
    cfg, root, _ = flagship_export
    with pytest.raises(NotImplementedError, match=match):
        export_model(cfg, root / "run", tmp_path, device="cpu",
                     **{flag: True})


def test_export_writes_a_torch_export_program(flagship_export, tmp_path):
    """``--to-torch-export`` (``export_model(to_torch_export=True)``)."""
    cfg, root, _ = flagship_export
    path = tmp_path / "pipeline.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "a"
    assert export_cli.main([
        "--pipeline-config", str(path), "--checkpoint-directory",
        str(root / "run"), "--output-directory", str(out),
        "--to-torch-export", "--device", "cpu"]) == 0
    assert (out / TORCH_EXPORT_FILE).is_file()
    program = load_torch_export(out, device="cpu")
    model = bidt.load_model(out, device="cpu", dtype="float32",
                            blend=False).model
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (2, 64, 128, 3)).astype(np.float32))
    with torch.no_grad():
        ref = model(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
    assert float((program(x) - ref).abs().max()) <= 1e-5


def test_export_cli_on_cpu(flagship_export, tmp_path):
    cfg, root, _ = flagship_export
    path = tmp_path / "pipeline.json"
    path.write_text(json.dumps(cfg))
    args = ["--pipeline-config", str(path), "--checkpoint-directory",
            str(root / "run"), "--device", "cpu"]
    assert export_cli.main(args + ["--output-directory",
                                   str(tmp_path / "a"), "--no-stablehlo",
                                   "--test-model", "--no-ema"]) == 0
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "params.msgpack", "pipeline.json"]
    for flag, match in (("--to-stablehlo", "to_torch_export"),
                        ("--to-tflite", "no converter")):
        with pytest.raises(NotImplementedError, match=match):
            export_cli.main(args + ["--output-directory",
                                    str(tmp_path / "b"), flag])
    assert export_cli.main(["--pipeline-config", str(tmp_path / "none"),
                            "--checkpoint-directory", str(root / "run"),
                            "--output-directory", str(tmp_path / "c")]) == 1


# ---------------------------------------------------------------- build

@pytest.mark.parametrize("name", [CONFIG, RESNET, "unet_laplacian_v4"])
def test_build_cli_matches_jax_build(tmp_path, name):
    path = tmp_path / "pipeline.json"
    path.write_text(json.dumps(bidt.CONFIGS_DICT[name]))
    assert build_cli.main(["--pipeline-config", str(path),
                           "--output-directory", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    assert jax_build.main(["--pipeline-config", str(path),
                           "--output-directory", str(tmp_path / "jax")]) == 0
    got, ref = (json.loads((tmp_path / d / "model_structure.json")
                           .read_text()) for d in ("port", "jax"))
    assert got == ref
    # JAX's reader takes the port's params into its own template
    data = (tmp_path / "port" / "params.msgpack").read_bytes()
    template = fser.msgpack_restore(
        (tmp_path / "jax" / "params.msgpack").read_bytes())
    template = {k: v for k, v in template.items()
                if k in ("params", "batch_stats")}
    restored = fser.from_bytes(template, data)
    assert jax.tree_util.tree_map(np.shape, restored) == \
        jax.tree_util.tree_map(np.shape, template)
    with pytest.raises(NotImplementedError, match="no converter"):
        build_cli.main(["--pipeline-config", str(path),
                        "--output-directory", str(tmp_path / "k"),
                        "--keras", "--device", "cpu"])
