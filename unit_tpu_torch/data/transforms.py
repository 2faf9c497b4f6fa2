"""Test-time image transform to a fixed, orientation-bucketed canvas.

Port of the test side of unit_tpu/data/transforms.py:18-132 (numpy only):
resize the shortest edge, cap the longest, and paste into a zero canvas of
one shape per orientation.  Images are float32 BGR (INPUT.FORMAT=BGR).
unit_tpu.data is not imported: its package import pulls in jax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TransformConfig:
    min_sizes: Sequence[int] = (800,)
    max_size: int = 1333
    canvas: Tuple[int, int] = (800, 1344)  # fixed (H, W) bucket

    @classmethod
    def test_from_cfg(cls, cfg) -> "TransformConfig":
        min_size = cfg.INPUT.MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
        canvas = _canvas_for(min_size, max_size, cfg.TPU.SIZE_DIVISIBILITY)
        return cls(min_sizes=(min_size,), max_size=max_size, canvas=canvas)


def _canvas_for(min_size: int, max_size: int, divisibility: int) -> Tuple[int, int]:
    def rup(x):
        return ((x + divisibility - 1) // divisibility) * divisibility

    return (rup(min_size), rup(max_size))


def oriented_canvas(h: int, w: int, canvas: Tuple[int, int]) -> Tuple[int, int]:
    """Portrait content (h > w) gets the transposed canvas."""
    ch, cw = canvas
    if h > w:
        return max(ch, cw), min(ch, cw)
    return min(ch, cw), max(ch, cw)


def resize_shortest_edge(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int, float]:
    """New (h, w, scale) with shortest edge = min_size, longest capped at max_size."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale)), scale


def resize_image(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize HxWx3 float32 via separable linear interpolation."""
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):
        return np.asarray(img, np.float32)
    ys = (np.arange(new_h) + 0.5) * (h / new_h) - 0.5
    xs = (np.arange(new_w) + 0.5) * (w / new_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def prepare_test_image(image: np.ndarray, tcfg: TransformConfig) -> dict:
    """The image part of unit_tpu's prepare_detection_record (training=False):
    {image [Hc, Wc, 3] canvas, image_size [2] (h, w) of the content,
    scale, orig_size [2]}."""
    h, w = image.shape[:2]
    new_h, new_w, scale = resize_shortest_edge(h, w, tcfg.min_sizes[0], tcfg.max_size)
    ch, cw = oriented_canvas(h, w, tcfg.canvas)
    new_h, new_w = min(new_h, ch), min(new_w, cw)
    img = resize_image(image, new_h, new_w)
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:new_h, :new_w] = img[:new_h, :new_w]
    return {
        "image": canvas,
        "image_size": np.asarray([new_h, new_w], np.float32),
        "scale": np.float32(scale),
        "orig_size": np.asarray([h, w], np.float32),
    }
