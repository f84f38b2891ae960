"""Color reconstruction helpers (port of v2v_tpu/utils/color.py;
reference utils/color_utils.py): combine RGBW Bayer-channel
reconstructions with a full-resolution grayscale into one color image.
numpy on the host; OpenCV is imported by the functions that need it."""
from __future__ import annotations

from typing import Dict

import numpy as np


def shift_image(x: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Shift by (dx, dy) with edge replication (utils/color_utils.py:
    6-17)."""
    x = np.roll(x, dy, axis=0)
    x = np.roll(x, dx, axis=1)
    if dy > 0:
        x[:dy, :] = x[dy, :][None]
    elif dy < 0:
        x[dy:, :] = x[dy, :][None]
    if dx > 0:
        x[:, :dx] = x[:, dx][:, None]
    elif dx < 0:
        x[:, dx:] = x[:, dx][:, None]
    return x


def upsample_color_image(gray_highres: np.ndarray,
                         color_lowres_bgr: np.ndarray,
                         colorspace: str = "LAB") -> np.ndarray:
    """Replace the luminance of an upsampled color image with a
    high-resolution grayscale (utils/color_utils.py:20-52)."""
    import cv2
    if gray_highres.ndim != 2:
        raise ValueError("gray_highres must be (H, W)")
    if color_lowres_bgr.ndim != 3 or color_lowres_bgr.shape[2] != 3:
        raise ValueError("color_lowres_bgr must be (H, W, 3)")
    codes = {
        "LAB": (cv2.COLOR_BGR2LAB, cv2.COLOR_LAB2BGR, 0),
        "HSV": (cv2.COLOR_BGR2HSV, cv2.COLOR_HSV2BGR, 2),
        "HLS": (cv2.COLOR_BGR2HLS, cv2.COLOR_HLS2BGR, 1),
    }
    fwd, bwd, lum = codes[colorspace]
    converted = cv2.cvtColor(src=color_lowres_bgr, code=fwd)
    converted[:, :, lum] = gray_highres
    return cv2.cvtColor(src=converted, code=bwd)


def merge_channels_into_color_image(channels: Dict[str, np.ndarray]
                                    ) -> np.ndarray:
    """A full-resolution grayscale and quarter-resolution R/G/B/W
    reconstructions (uint8) -> a BGR image (utils/color_utils.py:55-110):
    each channel upsampled x2 and shifted to its Bayer origin, G and W
    averaged, then the grayscale put in as the luminance."""
    import cv2
    missing = [k for k in ("R", "G", "B", "W", "grayscale")
               if k not in channels]
    if missing:
        raise KeyError(f"channels missing {missing}")
    ch = dict(channels)
    for k in ("R", "G", "W", "B"):
        ch[k] = cv2.resize(ch[k], dsize=None, fx=2, fy=2,
                           interpolation=cv2.INTER_LINEAR)
    ch["B"] = shift_image(ch["B"], dx=1, dy=1)
    ch["G"] = shift_image(ch["G"], dx=1, dy=0)
    ch["W"] = shift_image(ch["W"], dx=0, dy=1)
    g = cv2.addWeighted(src1=ch["G"], alpha=0.5, src2=ch["W"], beta=0.5,
                        gamma=0.0, dtype=cv2.CV_8U)
    color = np.dstack([ch["B"], g, ch["R"]]).astype(np.uint8)   # BGR
    return upsample_color_image(ch["grayscale"], color)
