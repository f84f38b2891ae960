"""ColorNet: color inference with a grayscale recurrent model (port of
v2v_tpu/models/color.py; reference model/model.py:27-77). The event
tensor splits into its RGBW Bayer sub-channels and the full-resolution
grayscale; the model runs on each with a state of its own, and the five
reconstructions merge into one BGR image on the host
(utils/color.py)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..ops.pad import CropParameters
from ..utils.color import merge_channels_into_color_image

_CHANNELS = {
    "R": (slice(0, None, 2), slice(0, None, 2)),
    "G": (slice(0, None, 2), slice(1, None, 2)),
    "B": (slice(1, None, 2), slice(1, None, 2)),
    "W": (slice(1, None, 2), slice(0, None, 2)),
    "grayscale": (slice(None), slice(None)),
}


class ColorNet:
    """Wraps a grayscale model (the stateful-step contract of
    models/model.py) with a streaming state a channel."""

    def __init__(self, model: nn.Module, num_encoders: int = 3):
        self.model = model
        self.num_encoders = num_encoders
        self.states: Dict[str, Any] = {}

    def reset_states(self) -> None:
        self.states = {}

    @torch.no_grad()
    def __call__(self, event_tensor: np.ndarray) -> Dict[str, np.ndarray]:
        """event_tensor (1, H, W, bins) -> {'image': (H, W, 3) BGR
        uint8}."""
        self.model.eval()
        dev = next(self.model.parameters()).device
        h, w = event_tensor.shape[1:3]
        crop_full = CropParameters(w, h, self.num_encoders)
        crop_half = CropParameters(w // 2, h // 2, self.num_encoders)
        recs = {}
        for name, (sy, sx) in _CHANNELS.items():
            crop = crop_full if name == "grayscale" else crop_half
            ev = torch.as_tensor(np.ascontiguousarray(
                event_tensor[:, sy, sx, :]), device=dev).permute(0, 3, 1, 2)
            ev = crop.pad(ev)
            if name not in self.states:
                self.states[name] = self.model.init_state(
                    1, ev.shape[2], ev.shape[3], device=dev)
            out, self.states[name] = self.model(ev, self.states[name])
            img = crop.crop(out["image"])[0, 0].cpu().numpy()
            recs[name] = np.clip(img * 255, 0, 255).astype(np.uint8)
        return {"image": merge_channels_into_color_image(recs)}
