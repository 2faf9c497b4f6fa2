"""Detection service over the predict path (port of
unit_tpu/serving/server.py:184-334, batch 1).

``DetectionService.detect_array`` takes an HxWx3 float BGR image, applies the
evaluation transform (resize shortest edge, orientation-bucketed canvas),
runs the model and returns detections in original-image coordinates.  The
HTTP front end, the micro-batcher, the uint8 wire, encoded-image decoding and
the exported-program path are not ported yet (ROADMAP Queue 1 item 28).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from ..data.transforms import TransformConfig, prepare_test_image
from ..engine.predict import make_predict_fn


class DetectionService:
    """prep -> predict -> detections, one request at a time."""

    def __init__(self, cfg, model, class_names: Optional[Sequence[str]] = None):
        if cfg.TPU.HOST_TRANSFER_UINT8:
            raise NotImplementedError(
                "TPU.HOST_TRANSFER_UINT8 is not ported (ROADMAP Queue 1 item 29)")
        if cfg.TPU.FOLD_BN_AT_EVAL:
            from ..utils.bn_fold import fold_frozen_bn

            model = fold_frozen_bn(model)  # a folded copy, made once
        self.tcfg = TransformConfig.test_from_cfg(cfg)
        self.class_names = list(class_names) if class_names else None
        self._lock = threading.Lock()  # one request on the device at a time
        self._predict = make_predict_fn(model)

    def detect_array(self, image_bgr: np.ndarray):
        """image [H, W, 3] float BGR (0-255) -> list of detection dicts."""
        h, w = image_bgr.shape[:2]
        s = prepare_test_image(image_bgr, self.tcfg)
        return self._detect_prepared(s["image"], s["image_size"], s["scale"], h, w)

    def _detect_prepared(self, image, image_size, scale, h, w):
        size = np.asarray(image_size, np.float32)
        with self._lock:
            # under MODEL.MASK_ON the device computes the masks too (predict
            # does), but a response carries none, as unit_tpu's does not
            det = self._predict(image[None], size[None])
            out = {
                "boxes": det.boxes[0].cpu().numpy(),
                "scores": det.scores[0].cpu().numpy(),
                "classes": det.classes[0].cpu().numpy(),
                "valid": det.valid[0].cpu().numpy(),
            }
        return self._format(out, scale, h, w)

    def _format(self, out: dict, scale: float, h: int, w: int):
        boxes = out["boxes"] / scale
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        recs = []
        for i in np.flatnonzero(out["valid"]):
            cid = int(out["classes"][i])
            rec = {
                "box": [float(v) for v in boxes[i]],
                "score": float(out["scores"][i]),
                "class_id": cid,
            }
            if self.class_names and 0 <= cid < len(self.class_names):
                rec["class_name"] = self.class_names[cid]
            recs.append(rec)
        recs.sort(key=lambda r: -r["score"])
        return recs

    def warmup(self):
        """One request per canvas orientation (landscape, then portrait)."""
        lo, hi = sorted(self.tcfg.canvas)
        for hh, ww in ((lo, hi), (hi, lo)):
            self.detect_array(np.zeros((hh, ww, 3), np.float32))
        return self
