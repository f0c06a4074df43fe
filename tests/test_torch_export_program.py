"""The port's serving artifact, a ``torch.export`` program
(``inference/export.py``: ``serialize_torch_export``,
``load_torch_export``, ``denoiser.pt2``), the counterpart of JAX's
StableHLO, on the CPU.

* The packaged flagship exported in float32 on the CPU comes out
  shape-polymorphic (batch, 64·h, 64·w) with 10 ``bidt::convnext_block``
  and 2 ``bidt::band_smooth`` nodes (K1 and K2 as custom operators);
  loaded back, it equals the port's eager forward within 1e-5 at two
  shapes, and JAX's ``load_stablehlo`` of ``serialize_stablehlo`` at
  (1, 128, 128, 3) within 1e-3 on [0, 255]. A directory without the file
  raises.
* A ConvNext unit at K1's C = 128 shapes, (128, 5) and (128, 1), exports
  as one ``bidt::convnext_block`` node (the operator is generic in C and
  K) and the program equals the unit's eager forward within 1e-5.
"""

from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.inference.export import (
    load_stablehlo, serialize_stablehlo)
from blind_image_denoising_torch.inference.export import (
    TORCH_EXPORT_FILE, load_torch_export, serialize_torch_export)
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.weights import load_msgpack, params_from_flax

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"


@pytest.fixture(scope="module")
def flagship_export(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_export")
    cfg = bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"]
    hydra = model_builder(cfg["model"]).hydra
    hydra.load_state_dict(params_from_flax(load_msgpack(
        Path(bidt.models[FLAGSHIP]["directory"]) / "params.msgpack")))
    blob, dynamic = serialize_torch_export(hydra, (1, 128, 128, 3))
    (root / TORCH_EXPORT_FILE).write_bytes(blob)
    return hydra.eval(), root, dynamic


def test_torch_export_matches_eager(flagship_export):
    hydra, root, dynamic = flagship_export
    assert dynamic
    program = torch.export.load(str(root / TORCH_EXPORT_FILE))
    nodes = Counter(str(n.target) for n in program.graph.nodes
                    if n.op == "call_function")
    assert nodes["bidt.convnext_block.default"] == 10
    assert nodes["bidt.band_smooth.default"] == 2
    fn = load_torch_export(root, device="cpu")
    rng = np.random.default_rng(3)
    for shape in ((1, 128, 128, 3), (3, 64, 192, 3)):
        x = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
        with torch.no_grad():
            ref = hydra(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
        got = fn(x)
        assert got.shape == shape
        assert float((got - ref).abs().max()) <= 1e-5


def test_torch_export_matches_jax_stablehlo(flagship_export):
    _, root, _ = flagship_export
    jden = bid.load_model(FLAGSHIP, dtype="float32")
    shape = (1, 128, 128, 3)
    blob = serialize_stablehlo(jden.model, jden.variables,
                               reference_shape=shape)
    (root / "denoiser.stablehlo").write_bytes(blob)
    x = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(load_stablehlo(root)(jnp.asarray(x)))
    got = load_torch_export(root, device="cpu")(x).numpy()
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_torch_export_is_missing(tmp_path):
    with pytest.raises(ValueError, match="to_torch_export"):
        load_torch_export(tmp_path, device="cpu")


@pytest.mark.parametrize("ck", [(128, 5), (128, 1), (256, 5), (108, 5)])
def test_convnext_unit_exports_at_c128(ck):
    """A unit at C = 128, at the wide class's C = 256 and at a C that is no
    multiple of 16 exports as one ``bidt::convnext_block`` node (its fake
    carries no shape of its own) and matches eager."""
    from blind_image_denoising_torch.layers.convnext import ConvNextBlock
    c, k = ck
    unit = ConvNextBlock(c, k, 4 * c)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    unit.eval().requires_grad_(False)
    x = torch.randn((2, c, 12, 20), generator=gen).contiguous(
        memory_format=torch.channels_last)
    program = torch.export.export(unit, (x,))
    nodes = Counter(str(n.target) for n in program.graph.nodes
                    if n.op == "call_function")
    assert nodes["bidt.convnext_block.default"] == 1
    with torch.no_grad():
        ref = unit(x)
    got = program.module()(x)
    assert got.shape == x.shape
    assert float((got - ref).abs().max()) <= 1e-5
