"""The port's pure-Python msgpack reader and the flax → torch layout
conversion (blind_image_denoising_torch/weights.py), held against
flax.serialization on the packaged artifacts."""

import os

import jax
import numpy as np
import pytest
import flax.serialization

import blind_image_denoising_tpu as bid
from blind_image_denoising_torch.weights import (msgpack_restore,
                                                 params_from_flax)

ARTIFACTS = ["unet_laplacian_v6_tpu_scratch", "resnet_depthwise_scratch",
             "unet_laplacian_v56_highnoise"]


def _leaves(tree):
    return [("/".join(str(k.key) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_reader_matches_flax_on_packaged_params(name):
    path = os.path.join(bid.models[name]["directory"], "params.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    ours, ref = _leaves(msgpack_restore(data)), _leaves(
        flax.serialization.msgpack_restore(data))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (p, a), (_, b) in zip(ours, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, p
        assert a.tobytes() == b.tobytes(), p


def test_reader_covers_scalars_and_containers():
    tree = {"f32": np.float32(1.5), "i64": np.int64(-7), "u8": np.uint8(200),
            "arr": np.arange(6, dtype=np.int32).reshape(2, 3),
            "nested": {"a": 3, "b": -40, "c": 70000, "d": -2 ** 40,
                       "e": 2.25, "f": "text", "g": True, "h": None,
                       "i": b"\x00\x01raw", "j": [1, "two", 3.0]}}
    data = flax.serialization.msgpack_serialize(tree)
    ours = msgpack_restore(data)
    ref = flax.serialization.msgpack_restore(data)
    assert ours["nested"] == ref["nested"]
    for k in ("f32", "i64", "u8", "arr"):
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_params_from_flax_layouts():
    path = os.path.join(bid.models[ARTIFACTS[0]]["directory"],
                        "params.msgpack")
    with open(path, "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    sd = params_from_flax(tree)
    p = tree["params"]
    stem = p["backbone"]["stem_conv"]["kernel"]                 # HWIO
    np.testing.assert_array_equal(sd["backbone.stem_conv.kernel"].numpy(),
                                  np.transpose(stem, (3, 2, 0, 1)))
    unit = p["backbone"]["encoder_1_0"]
    dw = sd["backbone.encoder_1_0.conv_1.kernel"]
    assert tuple(dw.shape) == (64, 1, 5, 5)
    np.testing.assert_array_equal(dw.numpy()[:, 0],
                                  np.transpose(unit["conv_1"]["kernel"][:, :, 0],
                                               (2, 0, 1)))
    w2 = sd["backbone.encoder_1_0.conv_2.kernel"]
    w3 = sd["backbone.encoder_1_0.conv_3.kernel"]
    assert tuple(w2.shape) == (256, 64) and tuple(w3.shape) == (64, 256)
    np.testing.assert_array_equal(w2.numpy(), unit["conv_2"]["kernel"][0, 0].T)
    np.testing.assert_array_equal(w3.numpy(), unit["conv_3"]["kernel"][0, 0].T)
    # 1x1 convs outside a ConvNext unit keep their 4-D OIHW shape
    q = sd["backbone.encoder_2_0_attn.query_conv.kernel"]
    assert tuple(q.shape) == (32, 128, 1, 1)
    assert len(sd) == len(_leaves(tree))
