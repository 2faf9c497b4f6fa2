"""Host-side image transforms to a fixed, orientation-bucketed canvas.

Port of unit_tpu/data/transforms.py (numpy only): resize the shortest edge,
cap the longest, random flip when training, paste into a zero canvas of one
shape per orientation, and pad the annotations to fixed shapes (under
MODEL.MASK_ON with them each GT instance's bitmask in its box's frame).
Images are float32 BGR (INPUT.FORMAT=BGR).  With ``proposal_capacity`` > 0
a record's precomputed proposals come padded to that capacity, scaled,
clipped and flipped with the image (data/proposals.py).  ``tta_canvas_for``
and ``max_aspect_of`` size the test-time augmentation's per-scale canvases.
``prepare_detection_record(..., preprocessed=...)`` takes a canvas that the
C loader (data/native.py) already made and transforms only the annotations;
``TransformConfig.host_uint8`` (TPU.HOST_TRANSFER_UINT8) makes the stream
loaders ship their batches' images as uint8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .proposals import pad_record_proposals


@dataclasses.dataclass
class TransformConfig:
    min_sizes: Sequence[int] = (800,)
    max_size: int = 1333
    canvas: Tuple[int, int] = (800, 1344)  # fixed (H, W) bucket
    flip: bool = True
    max_gt: int = 100
    num_classes: int = 20
    with_masks: bool = False
    mask_size: int = 28                    # GT-box-frame mask resolution
    proposal_capacity: int = 0             # > 0: padded precomputed proposals
    host_uint8: bool = False               # uint8 batch images (TPU.HOST_TRANSFER_UINT8)

    @classmethod
    def train_from_cfg(cls, cfg) -> "TransformConfig":
        min_sizes = cfg.INPUT.MIN_SIZE_TRAIN
        if isinstance(min_sizes, int):
            min_sizes = (min_sizes,)
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
        canvas = _canvas_for(max(min_sizes), max_size, cfg.TPU.SIZE_DIVISIBILITY)
        return cls(
            min_sizes=tuple(min_sizes), max_size=max_size, canvas=canvas,
            flip=cfg.INPUT.RANDOM_FLIP != "none", max_gt=cfg.TPU.MAX_GT_BOXES,
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES, with_masks=cfg.MODEL.MASK_ON,
            host_uint8=cfg.TPU.HOST_TRANSFER_UINT8,
        )

    @classmethod
    def test_from_cfg(cls, cfg) -> "TransformConfig":
        min_size = cfg.INPUT.MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
        canvas = _canvas_for(min_size, max_size, cfg.TPU.SIZE_DIVISIBILITY)
        return cls(
            min_sizes=(min_size,), max_size=max_size, canvas=canvas, flip=False,
            max_gt=cfg.TPU.MAX_GT_BOXES, num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        )


def _canvas_for(min_size: int, max_size: int, divisibility: int) -> Tuple[int, int]:
    def rup(x):
        return ((x + divisibility - 1) // divisibility) * divisibility

    return (rup(min_size), rup(max_size))


def tta_canvas_for(min_size: int, max_size: int, divisibility: int,
                   max_aspect: float) -> Tuple[int, int]:
    """Tight per-scale TTA canvas: a shortest-edge resize to ``min_size`` has
    a long side of at most ``min_size * max_aspect`` (capped at
    ``max_size``), so the canvas stops there instead of at ``max_size``.  The
    content and its zero padding are the same; only dead columns go."""
    def rup(x):
        return ((x + divisibility - 1) // divisibility) * divisibility

    long_side = min(int(math.ceil(min_size * max_aspect)), max_size)
    return (rup(min_size), rup(max(long_side, min_size)))


def max_aspect_of(records) -> float:
    """Max(long/short) aspect ratio over a dataset's records (TTA canvases)."""
    ar = 1.0
    for r in records:
        w, h = float(r.get("width", 0) or 0), float(r.get("height", 0) or 0)
        if w > 0 and h > 0:
            ar = max(ar, w / h, h / w)
    return ar


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


def resize_to_canvas(image: np.ndarray, min_size: int, tcfg: TransformConfig,
                     flip: bool = False):
    """(canvas [Hc, Wc, 3], new_h, new_w, scale): the image resized to
    ``min_size`` on its shortest edge (longest capped), optionally flipped,
    in the top-left corner of its orientation's zero canvas."""
    h, w = image.shape[:2]
    new_h, new_w, scale = resize_shortest_edge(h, w, min_size, tcfg.max_size)
    ch, cw = oriented_canvas(h, w, tcfg.canvas)
    new_h, new_w = min(new_h, ch), min(new_w, cw)
    img = resize_image(image, new_h, new_w)
    if flip:
        img = img[:, ::-1]
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:new_h, :new_w] = img[:new_h, :new_w]
    return canvas, new_h, new_w, scale


def load_image_bgr(path: str) -> np.ndarray:
    """Read an image file to float32 BGR HxWx3."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.float32)
    return rgb[:, :, ::-1].copy()


def prepare_detection_record(
    record: dict,
    tcfg: TransformConfig,
    rng: np.random.RandomState,
    image: Optional[np.ndarray] = None,
    training: bool = True,
    aug: Optional[tuple] = None,
    preprocessed: Optional[tuple] = None,
) -> dict:
    """record dict -> fixed-shape arrays for one image:
    {image [Hc, Wc, 3], image_size [2], gt_boxes [G, 4], gt_classes [G],
    gt_valid [G], labels [C], scale, image_id, orig_size}; with
    ``tcfg.with_masks`` gt_masks [G, M, M] f32: each annotation's
    ``box_mask`` in its GT box's frame (zeros where it has none), mirrored
    along x when the image is flipped; with ``tcfg.proposal_capacity`` P,
    proposals [P, 4] and proposals_valid [P] (``pad_record_proposals``,
    mirrored with the image).

    ``aug=(min_size, flip)``: the caller already drew the augmentation
    parameters (StreamLoader draws them once per record, so that
    ``fast_forward`` can replay them and the C path and the PIL fallback
    stay on one stream); no draws happen here.

    ``preprocessed=(canvas, new_h, new_w, scale[, flipped])``: the decode,
    resize, flip and canvas fill were done already (by the C loader,
    data/native.py); only the annotations are transformed here, mirrored
    where the image came flipped.  The original size is the record's.
    """
    if preprocessed is not None:
        canvas, new_h, new_w, scale = preprocessed[:4]
        flipped = bool(preprocessed[4]) if len(preprocessed) > 4 else False
        h, w = int(record["height"]), int(record["width"])
    else:
        if image is None:
            image = load_image_bgr(record["file_name"])
        h, w = image.shape[:2]
        if aug is not None:
            min_size, flipped = aug[0], bool(aug[1])
        else:  # the draws in unit_tpu's order: the size, then the flip coin
            min_size = (tcfg.min_sizes[rng.randint(len(tcfg.min_sizes))] if training
                        else tcfg.min_sizes[0])
            flipped = bool(training and tcfg.flip and rng.rand() < 0.5)
        canvas, new_h, new_w, scale = resize_to_canvas(image, min_size, tcfg, flipped)

    annotations = record.get("annotations", [])
    boxes = np.asarray([a["bbox"] for a in annotations], np.float32).reshape(-1, 4) * scale
    classes = np.asarray([a["category_id"] for a in annotations], np.int64)
    if flipped and len(boxes):
        x1 = new_w - boxes[:, 2]
        x2 = new_w - boxes[:, 0]
        boxes[:, 0], boxes[:, 2] = x1.copy(), x2.copy()

    g = tcfg.max_gt
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_classes = np.zeros((g,), np.int32)
    gt_valid = np.zeros((g,), bool)
    n = min(len(boxes), g)
    if n:
        gt_boxes[:n] = boxes[:n]
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = True

    labels = np.zeros((tcfg.num_classes,), np.float32)
    for c in classes:
        if 0 <= c < tcfg.num_classes:
            labels[c] = 1.0

    out = {
        "image": canvas,
        "image_size": np.asarray([new_h, new_w], np.float32),
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "labels": labels,
        "scale": np.float32(scale),
        "image_id": record.get("image_id", ""),
        "orig_size": np.asarray([h, w], np.float32),
    }
    if tcfg.with_masks:
        m = tcfg.mask_size
        gt_masks = np.zeros((g, m, m), np.float32)
        for i, ann in enumerate(annotations[:g]):
            bm = ann.get("box_mask")
            if bm is not None:
                # a GT-box-frame mask does not change with the resize; the
                # flip mirrors it along x
                bm = bm.astype(np.float32)
                gt_masks[i] = bm[:, ::-1] if flipped else bm
        out["gt_masks"] = gt_masks
    if tcfg.proposal_capacity > 0:
        p_boxes, p_valid = pad_record_proposals(record, scale, tcfg.proposal_capacity,
                                                new_w=new_w, new_h=new_h)
        if flipped:
            x1p = new_w - p_boxes[:, 2]
            x2p = new_w - p_boxes[:, 0]
            p_boxes[:, 0], p_boxes[:, 2] = x1p, x2p
        out["proposals"] = p_boxes
        out["proposals_valid"] = p_valid
    return out


def collate(samples: List[dict], keys: Sequence[str]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def prepare_test_image(image: np.ndarray, tcfg: TransformConfig) -> dict:
    """The image part of unit_tpu's prepare_detection_record (training=False):
    {image [Hc, Wc, 3] canvas, image_size [2] (h, w) of the content,
    scale, orig_size [2]}."""
    h, w = image.shape[:2]
    canvas, new_h, new_w, scale = resize_to_canvas(image, tcfg.min_sizes[0], tcfg)
    return {
        "image": canvas,
        "image_size": np.asarray([new_h, new_w], np.float32),
        "scale": np.float32(scale),
        "orig_size": np.asarray([h, w], np.float32),
    }
