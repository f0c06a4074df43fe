"""Any-size uint8 denoiser (counterpart of
``blind_image_denoising_tpu/inference/denoiser.py`` ``Denoiser``, the
single-device, untiled, no-TTA path).

uint8 (or float) [H, W, C] or [B, H, W, C] → float32 on the device →
zero-pad H and W on the high side to a multiple of 64 → hydra forward
in the compute dtype → finest scale, cast to float32 → crop → blend
(on the cropped image) → round half to even → clip to [0, 255] → uint8.
The epilogue runs in float32, as in JAX: bf16 spacing is 1.0 gray
level above 128, so rounding in bf16 would add quantization.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.resize import nchw, nhwc


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Denoiser:
    def __init__(self, model: torch.nn.Module, device, cast_to_uint8=True,
                 pad_multiple: int = 64, blend=None, tta=False,
                 tile_rows: int = 0, mesh=None, quant: bool = False):
        if tta:
            raise NotImplementedError(
                "tta is not ported yet (ROADMAP Queue 1 item 10)")
        if tile_rows:
            raise NotImplementedError(
                "tiling is not ported yet (ROADMAP Queue 1 item 10)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (ROADMAP Queue 1 item 13)")
        if quant:
            raise NotImplementedError(
                "quant=True (int8 serving) is not ported yet (ROADMAP "
                "Queue 1 items 9-10)")
        if blend is not None and blend is not False:
            from .blend import BlendTable
            self._blend = BlendTable.from_any(blend)
        else:
            self._blend = None
        self.device = torch.device(device)
        self._model = model.eval().to(self.device)
        self._cast = cast_to_uint8
        self._pad_multiple = int(pad_multiple)

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def blend(self):
        return self._blend

    def _run_padded(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] float32 → finest-scale [B, H, W, C] float32."""
        _, h, w, _ = x.shape
        pad_h = _round_up(h, self._pad_multiple) - h
        pad_w = _round_up(w, self._pad_multiple) - w
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        y = nhwc(self._model(nchw(x.contiguous()))[0]).float()
        return y[:, :h, :w, :]

    def _float_pipeline(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("denoiser.forward"):
            y = self._run_padded(x)
        if self._blend is not None:
            with record_function("denoiser.blend"):
                y = self._blend.apply(x, y)
        return y

    def _to_device(self, image) -> torch.Tensor:
        t = image if isinstance(image, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(image))
        if t.ndim not in (3, 4):
            raise ValueError(f"image must be [H, W, C] or [B, H, W, C], got "
                             f"shape {tuple(t.shape)}")
        return t.to(self.device).float()

    @torch.inference_mode()
    def __call__(self, image) -> np.ndarray:
        """image: uint8/float [H, W, C] or [B, H, W, C] (numpy or torch);
        returns a numpy array of the same rank.

        The stages run inside ``torch.profiler`` ranges named
        ``denoiser.{to_device,forward,blend,epilogue}``, so a profile of
        requests splits their host and device time by stage."""
        with record_function("denoiser.to_device"):
            x = self._to_device(image)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        y = self._float_pipeline(x)
        with record_function("denoiser.epilogue"):
            y = torch.clamp(torch.round(y), 0.0, 255.0)
            if squeeze:
                y = y[0]
            if self._cast:
                y = y.to(torch.uint8)
            return y.cpu().numpy()
