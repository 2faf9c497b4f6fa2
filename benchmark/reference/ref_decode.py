"""The training loader's batches worked out again from the dataset's files
(``rebuild``): PIL's JPEG
decode (the decode of a host without libjpeg, and libjpeg-turbo's own
elsewhere) and a numpy copy of the C loader's half-pixel bilinear resize
into the top-left of a zero BGR float32 canvas (``ResizeToCanvas`` and
``ResizedDims`` of unit_tpu_torch/csrc/dataloader.cc, frozen here), in the
same float32 operations in the same order, so that it gives the same bits."""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

F32 = np.float32


def decode_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"), np.uint8))


def resized_dims(h: int, w: int, min_size: int, max_size: int, canvas_h: int,
                 canvas_w: int) -> Tuple[int, int, float]:
    """(nh, nw, scale): a double scale, rounded half to even, clamped."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh = max(min(int(round(h * scale)), canvas_h), 1)
    nw = max(min(int(round(w * scale)), canvas_w), 1)
    return nh, nw, float(F32(scale))


def _taps(n_src: int, n_dst: int):
    s = F32(n_src) / F32(n_dst)
    f = (np.arange(n_dst, dtype=F32) + F32(0.5)) * s - F32(0.5)
    f = np.maximum(f, F32(0.0))
    i0 = np.minimum(f.astype(np.int64), n_src - 1)
    i1 = np.minimum(i0 + 1, n_src - 1)
    return i0, i1, (f - i0.astype(F32)).astype(F32)


def resize_to_canvas(rgb: np.ndarray, min_size: int, max_size: int,
                     canvas: Tuple[int, int], flip: bool = False):
    """(canvas [Hc, Wc, 3] BGR float32, (nh, nw), scale) of an RGB uint8
    image, as the C loader makes them."""
    h, w = rgb.shape[:2]
    ch, cw = canvas
    nh, nw, scale = resized_dims(h, w, min_size, max_size, ch, cw)
    y0, y1, wy = _taps(h, nh)
    x0, x1, wx = _taps(w, nw)
    src = rgb.astype(F32)
    one = F32(1.0)
    wx3 = wx[None, :, None]
    top = src[y0][:, x0] * (one - wx3) + src[y0][:, x1] * wx3
    bot = src[y1][:, x0] * (one - wx3) + src[y1][:, x1] * wx3
    wy3 = wy[:, None, None]
    img = top * (one - wy3) + bot * wy3
    img = img[:, :, ::-1]  # RGB -> BGR
    if flip:
        img = img[:, ::-1]
    out = np.zeros((ch, cw, 3), F32)
    out[:nh, :nw] = img
    return out, (nh, nw), scale


def box_mask(polygons, box, size: int) -> np.ndarray:
    """COCO polygons drawn in the frame of ``box`` (x1, y1, x2, y2) on a
    ``size`` x ``size`` grid: a cell is set where its centre lies inside a
    polygon by the even-odd rule, edges included (the union over polygons)."""
    x1, y1, x2, y2 = (float(v) for v in box)
    w, h = max(x2 - x1, 1e-3), max(y2 - y1, 1e-3)
    c = np.arange(size) + 0.5
    out = np.zeros((size, size), bool)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        px, py = (pts[:, 0] - x1) / w * size, (pts[:, 1] - y1) / h * size
        qx, qy = np.roll(px, -1), np.roll(py, -1)
        y = c[:, None]
        cross = ((py <= y) & (y < qy)) | ((qy <= y) & (y < py))  # [rows, edges]
        xc = px + (y - py) / np.where(qy != py, qy - py, 1.0) * (qx - px)
        left = ((xc[:, None, :] < c[None, :, None]) & cross[:, None, :]).sum(-1)
        on = ((xc[:, None, :] == c[None, :, None]) & cross[:, None, :]).any(-1)
        out |= (left % 2 == 1) | on
    return out


def rebuild(batch: dict, ids, manifest: dict, dataset: str, base_ids, num_classes: int,
            min_sizes, max_size: int, max_gt: int):
    """A loader batch made again from the dataset's files: for each image
    (``ids``, in the batch's order) its JPEG decoded and resized as the C
    loader does to the batch's size (the MIN_SIZE_TRAIN that gives it) on
    the batch's canvas, flipped where the batch's image is; its annotations
    from ``manifest`` (what the dataset writer wrote) in the recipe's
    conventions: VOC's 1-based corners moved by one, the strong stream's
    boxes of base classes alone, scaled, mirrored with the image, padded to
    ``max_gt``; the weak stream's labels of every class in the image; COCO's
    masks drawn from their polygons in their boxes' frames.  Returns the
    batch and its gaps from the loader's: the largest pixel and box
    differences, and the counts of classes, flags, labels and mask cells
    that differ."""
    image = np.asarray(batch["image"], np.float32)
    strong = "gt_boxes" in batch
    canvas = image.shape[1:3]
    out = {"image": np.zeros_like(image), "image_size": np.asarray(batch["image_size"], np.float32)}
    if strong:
        out["gt_boxes"] = np.zeros((len(ids), max_gt, 4), np.float32)
        out["gt_classes"] = np.zeros((len(ids), max_gt), np.int32)
        out["gt_valid"] = np.zeros((len(ids), max_gt), bool)
        if "gt_masks" in batch:
            mask_size = np.asarray(batch["gt_masks"]).shape[-1]
            out["gt_masks"] = np.zeros((len(ids), max_gt, mask_size, mask_size), np.float32)
    else:
        out["labels"] = np.zeros((len(ids), num_classes), np.float32)
    for i, image_id in enumerate(ids):
        rec = manifest[image_id]
        with open(rec["file"], "rb") as f:
            rgb = decode_rgb(f.read())
        h, w = rgb.shape[:2]
        nh, nw = (int(v) for v in out["image_size"][i])
        size = next((m for m in min_sizes
                     if resized_dims(h, w, m, max_size, *canvas)[:2] == (nh, nw)), min_sizes[0])
        img, _, scale = resize_to_canvas(rgb, size, max_size, canvas)
        content, seen = img[:nh, :nw], image[i, :nh, :nw]
        flip = bool(np.abs(content[:, ::-1] - seen).max() < np.abs(content - seen).max())
        if flip:
            img[:nh, :nw] = content[:, ::-1].copy()
        out["image"][i] = img
        boxes = [list(b) for b in rec["boxes"]]
        if dataset == "VOC":
            boxes = [[b[0] - 1.0, b[1] - 1.0, b[2], b[3]] for b in boxes]
        if not strong:
            for c in rec["classes"]:
                out["labels"][i, c] = 1.0
            continue
        keep = [k for k, c in enumerate(rec["classes"]) if c in base_ids][:max_gt]
        bx = np.asarray([boxes[k] for k in keep], np.float32).reshape(-1, 4) * scale
        if flip:
            bx[:, [0, 2]] = nw - bx[:, [2, 0]]
        n = len(keep)
        out["gt_boxes"][i, :n] = bx
        out["gt_classes"][i, :n] = [rec["classes"][k] for k in keep]
        out["gt_valid"][i, :n] = True
        if "gt_masks" in out:
            for j, k in enumerate(keep):
                m = box_mask([rec["polygons"][k]], boxes[k], mask_size)
                out["gt_masks"][i, j] = m[:, ::-1] if flip else m
    gaps = {"image": float(np.abs(out["image"] - image).max())}
    if strong:
        gaps["boxes"] = float(np.abs(out["gt_boxes"] - np.asarray(batch["gt_boxes"])).max())
        gaps["labels"] = int((out["gt_classes"] != np.asarray(batch["gt_classes"])).sum()
                             + (out["gt_valid"] != np.asarray(batch["gt_valid"])).sum())
        if "gt_masks" in out:
            gaps["masks"] = int((out["gt_masks"] != np.asarray(batch["gt_masks"])).sum())
    else:
        gaps["labels"] = int((out["labels"] != np.asarray(batch["labels"])).sum())
    return out, gaps
