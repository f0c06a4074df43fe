"""Any-size uint8 denoiser (counterpart of
``blind_image_denoising_tpu/inference/denoiser.py`` ``Denoiser``, with its
signature and every option).

uint8 (or float) [H, W, C] or [B, H, W, C] → float32 on the device →
zero-pad H and W on the high side (to a multiple of ``pad_multiple``, or
to the next power of two with ``pad_mode="pow2"``) → hydra forward in
the compute dtype → finest scale, cast to float32 → crop → blend (on the
cropped image) → round half to even → clip to [0, 255] → uint8. The
epilogue runs in float32, as in JAX: bf16 spacing is 1.0 gray level
above 128, so rounding in bf16 would add quantization.

* ``tile_rows`` splits a large frame into overlapping bands with a
  ``tile_halo``; band starts align down to ``pad_multiple``, the longer
  axis is tiled first, and a band still over the bound on the other axis
  takes one perpendicular pass. Exact for a fully convolutional model
  whose receptive field fits the halo.
* ``tta`` averages the dihedral transforms t⁻¹(f(t(x))): ``True``/``8``
  the full group, ``4`` the flips, ``2`` {id, 180°}, each a closed
  subgroup. The members are summed in float64, so the mean does not
  depend on their order and is exactly equivariant to the subgroup:
  the epilogue rounds even with ``cast_to_uint8=False``, and a float32
  sum in another order moves a value near .5 across it (a transposed
  256² image on the card then differs by one gray level).
* ``blend`` serves the noise-adaptive input blend (``inference/blend.py``)
  after tiling and TTA.
* ``float_forward`` is the same pipeline without the epilogue, and
  differentiable with respect to its input; ``dispatch`` enqueues the
  whole pipeline and returns the result on the device with no host
  sync (the upload goes through pinned memory), the seam that
  ``serving.BatchingDenoiser`` pipelines; :class:`HostCopy` brings such
  a result back without a host sync until it is read.
* ``mesh`` with a 'spatial' axis of n > 1 ranks (``parallel/mesh.py``):
  every rank of the spatial sub-group serves the same image together;
  the padded frame's rows split into n slabs, each rank runs its slab
  with ``spatial_margin`` halo rows from its neighbours
  (``parallel/spatial.denoise_spatially_sharded``), and the slabs are
  gathered back, so every rank returns the whole image. The padded
  height must split into n slabs. ``tta`` is refused there, as in JAX
  (its transposes swap the sharded axis). The exchange and the gather
  are differentiable, so ``float_forward`` takes reverse- and
  forward-mode derivatives through the sharded forward, as JAX's
  ``jax.grad`` through ``shard_map`` does. A data-only mesh serves as
  without one.
"""

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.padding import next_power_of_2
from ..ops.precision import has_tangent
from ..ops.quant import has_scales, quant_mode
from ..ops.resize import nchw, nhwc
from ..parallel.spatial import (denoise_spatially_sharded, gather_spatial,
                                spatial_shard_image)
from ..weights import attach_quant_scales, flax_from_params, params_from_flax


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises; the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def as_uint8(x: np.ndarray) -> np.ndarray:
    """Round half to even and clip to [0, 255], as uint8 (a bare
    ``astype`` would wrap out-of-range floats modulo 256)."""
    if x.dtype == np.uint8:
        return x
    return np.clip(np.round(x.astype(np.float64)), 0, 255).astype(np.uint8)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _dihedral(x: torch.Tensor, k: int) -> torch.Tensor:
    """k ∈ 0..7: bit0 = left-right flip, bit1 = up-down flip, bit2 =
    transpose (H↔W). Applied in that order on NHWC."""
    if k & 1:
        x = x.flip(2)
    if k & 2:
        x = x.flip(1)
    if k & 4:
        x = x.transpose(1, 2)
    return x


def _dihedral_inv(y: torch.Tensor, k: int) -> torch.Tensor:
    if k & 4:
        y = y.transpose(1, 2)
    if k & 2:
        y = y.flip(1)
    if k & 1:
        y = y.flip(2)
    return y


class HostCopy:
    """A tensor's copy to host memory. For a CUDA tensor the copy goes
    into pinned memory without blocking and an event marks its end;
    ``np.asarray`` waits for that event only, not for the whole stream,
    so work queued after the copy keeps running."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cpu":
            self._host = t
            return
        with torch.inference_mode():
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


class Denoiser:
    def __init__(self, model: torch.nn.Module,
                 variables: Optional[Dict] = None, cast_to_uint8: bool = True,
                 pad_mode: str = "multiple", pad_multiple: int = 64,
                 tile_rows: int = 0,
                 tile_halo: int = 64, mesh=None, spatial_margin: int = 0,
                 quant: bool = False, tta=False, blend=None, *, device=None):
        """``variables``: the flax variables tree (numpy leaves:
        ``params`` [+ ``batch_stats``] [+ ``quant``]) loaded into
        ``model``; ``None`` keeps the model's own weights. ``device``:
        ``None`` is the card (raises without one); ``"cpu"`` runs on the
        CPU (under a mesh: this rank's card, the current device)."""
        if variables is not None and not isinstance(variables, dict):
            raise TypeError(
                f"variables must be a flax variables dict or None, got "
                f"{type(variables).__name__} (the device is keyword-only: "
                f"Denoiser(model, device=...))")
        if pad_mode not in ("multiple", "pow2"):
            raise ValueError(f"pad_mode must be 'multiple' or 'pow2', got "
                             f"{pad_mode!r}")
        members = 8 if tta is True else int(tta or 0)
        if members not in (0, 2, 4, 8):
            raise ValueError(f"tta must be False/True/2/4/8, got {tta!r}")
        self._tta_members = {0: (), 2: (0, 3), 4: (0, 1, 2, 3),
                             8: tuple(range(8))}[members]
        spatial = mesh is not None and mesh.shape.get("spatial", 1) > 1
        if tta and spatial:
            raise ValueError(
                "tta=True is single-mesh only: the transpose members of "
                "the dihedral ensemble swap H and W, which breaks a fixed "
                "'spatial' (H-axis) sharding")
        self.device = resolve_device(device)
        if variables is not None:
            model.load_state_dict(params_from_flax(variables), strict=True)
        self._model = model.eval().to(self.device)
        if quant and variables is not None and "quant" in variables:
            attach_quant_scales(self._model, variables["quant"])
        if quant and not has_scales(self._model):
            raise ValueError(
                "quant=True needs calibrated scales — run "
                "inference.quantize.calibrate(model, images) and pass its "
                "result as variables['quant'] (or attach it with "
                "weights.attach_quant_scales)")
        self._quant = bool(quant)
        if blend is not None and blend is not False:
            from .blend import BlendTable
            self._blend = BlendTable.from_any(blend)
        else:
            self._blend = None
        self._cast = cast_to_uint8
        self._pad_mode = pad_mode
        self._pad_multiple = int(pad_multiple)
        self._tile_rows = int(tile_rows)
        self._tile_halo = int(tile_halo)
        self._spatial = spatial
        if spatial:
            sharded = denoise_spatially_sharded(
                lambda _, x: self._apply(x), None, mesh, int(spatial_margin))
            self._forward = lambda x: gather_spatial(
                mesh, sharded(spatial_shard_image(mesh, x)))
        else:
            self._forward = self._apply

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        """The hydra's finest scale, NHWC float32 in and out."""
        return nhwc(self._model(nchw(x.contiguous()))[0]).float()

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def variables(self) -> Dict:
        """The model's variables as a flax tree of numpy arrays (params
        [+ batch_stats] [+ quant]), as JAX's ``Denoiser.variables``."""
        return flax_from_params(self._model)

    @property
    def blend(self):
        return self._blend

    def _pad_target(self, n: int) -> int:
        if self._pad_mode == "pow2":
            return next_power_of_2(n)
        return _round_up(n, self._pad_multiple)

    def _run_padded(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] float32 → finest-scale [B, H, W, C] float32."""
        _, h, w, _ = x.shape
        pad_h = self._pad_target(h) - h
        pad_w = self._pad_target(w) - w
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        mode = quant_mode("int8") if self._quant else contextlib.nullcontext()
        with record_function("denoiser.forward"), mode:
            y = self._forward(x)
        return y[:, :h, :w, :]

    def _run_tiled(self, x: torch.Tensor, axis: int = 1,
                   recurse: bool = True) -> torch.Tensor:
        """Band tiling with halo along ``axis`` (1 = rows, 2 = columns).
        Band starts align down to ``pad_multiple``, so every pyramid
        level samples the same row and column parities as the untiled
        frame; a band whose other axis is still over the bound takes one
        perpendicular pass (``recurse`` stops a second)."""
        n = x.shape[axis]
        t, halo = self._tile_rows, self._tile_halo
        align = max(1, self._pad_multiple)
        other = 3 - axis
        outs = []
        for start in range(0, n, t):
            stop = min(start + t, n)
            lo = (max(0, start - halo) // align) * align
            hi = min(n, stop + halo)
            band = x.narrow(axis, lo, hi - lo)
            band = self._run_tiled(band, axis=other, recurse=False) \
                if recurse and band.shape[other] > t \
                else self._run_padded(band)
            outs.append(band.narrow(axis, start - lo, stop - start))
        return torch.cat(outs, dim=axis)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        if self._tile_rows > 0:
            # the longer axis first (a transposed TTA member moves it to
            # axis 2)
            axis = 1 if x.shape[1] >= x.shape[2] else 2
            if x.shape[axis] > self._tile_rows:
                with record_function("denoiser.tile"):
                    return self._run_tiled(x, axis=axis)
        return self._run_padded(x)

    def _float_pipeline(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] float32 → [B, H, W, C] float32 (finest scale):
        tile, then the TTA mean, then the blend; no epilogue."""
        if self._tta_members:
            with record_function("denoiser.tta"):
                acc = None
                for k in self._tta_members:
                    yk = _dihedral_inv(
                        self._run(_dihedral(x, k).contiguous()), k).double()
                    acc = yk if acc is None else acc + yk
                y = (acc / float(len(self._tta_members))).float()
        else:
            y = self._run(x)
        if self._blend is not None:
            with record_function("denoiser.blend"):
                y = self._blend.apply(x, y)
        return y

    def _upload(self, image) -> torch.Tensor:
        """numpy or torch [H, W, C] / [B, H, W, C] → float32 on the
        device (a tensor already there is not copied); a host array goes
        through pinned memory without blocking."""
        t = image if isinstance(image, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(image))
        if t.ndim not in (3, 4):
            raise ValueError(f"image must be [H, W, C] or [B, H, W, C], got "
                             f"shape {tuple(t.shape)}")
        if t.device != self.device:
            # pinning copies the primal alone: a dual tensor is moved as
            # it is, with its tangent
            if (self.device.type == "cuda" and t.device.type == "cpu"
                    and not has_tangent(t)):
                t = t.pin_memory()
            t = t.to(self.device, non_blocking=True)
        return t.float()

    def float_forward(self, image) -> torch.Tensor:
        """Differentiable float forward: [H, W, C] or [B, H, W, C] float
        in [0, 255] → same-rank float32 denoised image on the device
        (finest scale), through the whole pad/tile/TTA/blend pipeline but
        without the round/clip/uint8 epilogue. An input that requires
        grad is differentiated through it (``torch.autograd.grad``; the
        ConvNext units then take their plain path, as in training); a
        dual tensor (``torch.autograd.forward_ad``) carries its tangent
        through it the same way, with autograd off; otherwise the forward
        runs without autograd."""
        x = self._upload(image)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and x.requires_grad):
            y = self._float_pipeline(x)
        return y[0] if squeeze else y

    @torch.inference_mode()
    def dispatch(self, image) -> torch.Tensor:
        """Enqueue the whole serving pipeline and return its result on
        the device (uint8, or float32 with ``cast_to_uint8=False``, the
        input's rank) without a host sync; :class:`HostCopy` brings it
        back.

        The stages run inside ``torch.profiler`` ranges named
        ``denoiser.{to_device,tile,tta,forward,blend,epilogue}``, so a
        profile of requests splits their host and device time by
        stage."""
        with record_function("denoiser.to_device"):
            x = self._upload(image)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        y = self._float_pipeline(x)
        with record_function("denoiser.epilogue"):
            y = torch.clamp(torch.round(y), 0.0, 255.0)
            if squeeze:
                y = y[0]
            return y.to(torch.uint8) if self._cast else y

    def __call__(self, image) -> np.ndarray:
        """image: uint8/float [H, W, C] or [B, H, W, C] (numpy or torch);
        returns a numpy array of the same rank."""
        return np.asarray(HostCopy(self.dispatch(image)))
