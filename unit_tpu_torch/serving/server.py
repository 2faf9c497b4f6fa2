"""Inference service over the predict path, and its HTTP front end (port of
unit_tpu/serving/server.py).

- ``DetectionService``: an image (encoded bytes or a float BGR array) ->
  detections in original-image coordinates, through the evaluation's
  test-time transform (resize the shortest edge, orientation-bucketed fixed
  canvas), a live model or an exported artifact (``serving.export``).
- Micro-batching (``batch_size > 1``): concurrent requests with the same
  canvas are grouped into one device call.  A live model pads a group to the
  next power of two (at most ``batch_size``); an artifact pads it to its one
  exported batch.
- ``DetectionServer``: a threaded HTTP front end --
    POST /predict  (body: JPEG/PNG bytes) -> JSON detections
    GET  /healthz  -> {"status": "ok"}
    GET  /metadata -> artifact/model metadata
  Each request is decoded and resized in its own handler thread (a JPEG in
  C with the GIL released, data/native.py, where the library builds; PIL
  and numpy otherwise); the device work queues on the card's stream.

A device call's outputs come back as one packed device-to-host copy into
pinned memory with one event (``evaluation.evaluator._start_fetch``), in the
caller's thread at batch 1 and in the batcher's fetch thread otherwise.
Under TPU.HOST_TRANSFER_UINT8 a prepared canvas is rounded to uint8 before
it is submitted (the uint8 wire: 4x fewer bytes to upload, at most 0.5 off);
the model casts it to f32 on the device.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data import native
from ..data.transforms import TransformConfig, oriented_canvas, prepare_test_image
from ..engine.predict import make_predict_fn
from ..evaluation.evaluator import _start_fetch

_STOP = object()


def _unpack(fetch) -> np.ndarray:
    """Wait for a ``_start_fetch`` copy -> host array [B, D, 7] (boxes,
    score, class, valid)."""
    host, _, event = fetch
    if event is not None:
        event.synchronize()
    return host.numpy()


def _fields(packed: np.ndarray) -> dict:
    """One image's row [D, 7] of the packed copy -> its output arrays."""
    return {"boxes": packed[:, :4], "scores": packed[:, 4],
            "classes": packed[:, 5].astype(np.int32), "valid": packed[:, 6] > 0}


class _MicroBatcher:
    """Groups concurrent predict calls into padded device batches.

    The dispatcher thread takes the first pending request, waits up to
    ``wait_ms`` for more requests with the SAME canvas shape (portrait and
    landscape are different inputs), pads the group and runs one device call;
    a request with the other canvas ends the group and goes back in the
    queue.  The fetch thread waits for each group's packed copy and hands
    every waiter its row, so group k + 1's stacking and dispatch overlap
    group k's copy.  At most two groups are in flight, each with its own
    pinned buffer.
    """

    def __init__(self, predict: Callable, batch_size: int, wait_ms: float,
                 fixed: bool = False):
        self._predict = predict
        self.batch_size = int(batch_size)
        # fixed: the predictor takes one batch size (an artifact), and every
        # group pads to it; else a group pads to the next power of two
        self._fixed = bool(fixed)
        self._wait_s = float(wait_ms) / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._fetch_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._fetch_thread = threading.Thread(target=self._fetch_loop, daemon=True)
        self._thread.start()
        self._fetch_thread.start()

    def submit(self, image: np.ndarray, size: np.ndarray) -> dict:
        """image [Hc, Wc, 3], size [2] -> dict of per-image output arrays."""
        item = {"image": image, "size": size, "event": threading.Event()}
        self._q.put(item)
        item["event"].wait()
        if "error" in item:
            raise item["error"]
        return item["out"]

    def close(self):
        # the dispatcher hands its last group to the fetch thread and then
        # stops it, so both joins end once the groups in flight are answered
        self._q.put(_STOP)
        self._thread.join()
        self._fetch_thread.join()
        # requests queued behind the stop sentinel (or put back behind it)
        # would block their submit() callers forever: fail them
        err = RuntimeError("MicroBatcher closed with requests pending")
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item["error"] = err
                item["event"].set()

    # -- dispatcher thread -------------------------------------------------
    def _loop(self):
        try:
            self._groups()
        finally:
            self._fetch_q.put(_STOP)  # after the last group this thread queued

    def _groups(self):
        # inference mode is a thread's own state: the predict call and the
        # packing of its outputs run under it here
        with torch.inference_mode():
            while True:
                first = self._q.get()
                if first is _STOP:
                    return
                group = [first]
                key = first["image"].shape
                deadline = time.monotonic() + self._wait_s
                stop = False
                while len(group) < self.batch_size:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is _STOP:
                        stop = True
                        break
                    if item["image"].shape != key:
                        self._q.put(item)  # the other orientation: the next group
                        break
                    group.append(item)
                self._dispatch(group)
                if stop:
                    return

    def _dispatch(self, group):
        try:
            n = len(group)
            if self._fixed:
                b = self.batch_size
            else:
                b = 1
                while b < n:
                    b *= 2
                b = min(b, self.batch_size)
            first = group[0]["image"]
            # the requests' own dtype: the model casts on the device
            images = np.zeros((b,) + first.shape, first.dtype)
            sizes = np.ones((b, 2), np.float32)
            for i, item in enumerate(group):
                images[i] = item["image"]
                sizes[i] = item["size"]
            fetch = _start_fetch(self._predict(images, sizes))
        except Exception as e:  # every waiter of the group gets the error
            for item in group:
                item["error"] = e
                item["event"].set()
            return
        self._fetch_q.put((group, fetch))

    # -- fetch thread ------------------------------------------------------
    def _fetch_loop(self):
        while True:
            job = self._fetch_q.get()
            if job is _STOP:
                return
            group, fetch = job
            try:
                packed = _unpack(fetch)
                for i, item in enumerate(group):
                    item["out"] = _fields(packed[i])
            except Exception as e:
                for item in group:
                    item["error"] = e
            finally:
                for item in group:
                    item["event"].set()


class DetectionService:
    """prep -> (micro-batched) predict -> detections, over a live model or an
    exported artifact (``serving.export.load_exported``)."""

    def __init__(self, cfg, model=None, exported=None,
                 class_names: Optional[Sequence[str]] = None, batch_size: int = 1,
                 batch_wait_ms: float = 5.0):
        if (model is None) == (exported is None):
            raise ValueError("need exactly one of model= and exported=")
        self.tcfg = TransformConfig.test_from_cfg(cfg)
        # the uint8 request wire; off by default, where a served result
        # equals the evaluation's bit for bit
        self.uint8_wire = bool(cfg.TPU.HOST_TRANSFER_UINT8)
        self.class_names = list(class_names) if class_names else None
        self._lock = threading.Lock()  # batch 1: one dispatch at a time
        if exported is not None:
            if exported.meta.get("with_proposals"):
                # such programs take (image, size, proposals, valid); an HTTP
                # request carries no precomputed proposals to feed them
                raise ValueError(
                    "artifact was exported with_proposals=True (a precomputed-proposal "
                    "model); DetectionService cannot source per-image proposals for "
                    "arbitrary requests: re-export with with_proposals=False (RPN "
                    "models) or evaluate with DATASETS.PROPOSAL_FILES_TEST")
            self._predict = exported
            self._canvases = {tuple(int(v) for v in key.split("x"))
                              for key in exported.meta["canvases"]}
            if exported.meta.get("class_names") and not self.class_names:
                self.class_names = list(exported.meta["class_names"])
            # an artifact exported at batch N takes batches of N only
            batch_size = int(exported.meta.get("batch_size", 1) or 1)
        else:
            if cfg.TPU.FOLD_BN_AT_EVAL:
                from ..utils.bn_fold import fold_frozen_bn

                model = fold_frozen_bn(model)  # a folded copy, made once
            self._predict = make_predict_fn(model)
            self._canvases = None  # a live model takes any canvas
        self.batch_size = int(batch_size)
        self._batcher = (
            _MicroBatcher(self._predict, self.batch_size, batch_wait_ms,
                          fixed=exported is not None)
            if self.batch_size > 1 else None)

    # -- input adapters ----------------------------------------------------
    def detect_bytes(self, data: bytes):
        """Decode an encoded image (JPEG/PNG/...) and run detection.

        A JPEG is decoded and resized in C with the GIL released
        (data/native.py: the header's dims pick the canvas, then
        ``prepare_image_mem``) where the library builds; anything else, and
        a JPEG the C decoder refuses, goes through PIL and numpy."""
        if data[:2] == b"\xff\xd8" and native.available():
            prepared = None
            try:
                h, w = native.decode_image_size_mem_native(data)
                prepared = native.prepare_image_mem_native(
                    data, self.tcfg.min_sizes[0], self.tcfg.max_size,
                    oriented_canvas(h, w, self.tcfg.canvas))
            except RuntimeError:
                pass  # not decodable in C: PIL gives the result or the error
            if prepared is not None:
                # outside the try: a device error (a RuntimeError too) must
                # propagate, not rerun the request through PIL
                image, size, scale, _ = prepared
                return self._detect_prepared(image, size, scale, h, w)
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        arr = np.asarray(img, np.float32)[:, :, ::-1]  # the model eats BGR
        return self.detect_array(arr)

    def detect_array(self, image_bgr: np.ndarray):
        """image [H, W, 3] float BGR (0-255) -> list of detection dicts."""
        h, w = image_bgr.shape[:2]
        s = prepare_test_image(image_bgr, self.tcfg)
        return self._detect_prepared(s["image"], s["image_size"], s["scale"], h, w)

    def _detect_prepared(self, image, image_size, scale, h, w):
        if self.uint8_wire and image.dtype != np.uint8:
            image = np.clip(np.rint(image), 0, 255).astype(np.uint8)
        size = np.asarray(image_size, np.float32)
        if self._batcher is not None:
            out = self._batcher.submit(image, size)
        else:
            # under MODEL.MASK_ON the device computes the masks too (predict
            # does), but a response carries none, as unit_tpu's does not
            with self._lock, torch.inference_mode():
                fetch = _start_fetch(self._predict(image[None], size[None]))
            out = _fields(_unpack(fetch)[0])
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
        """Run every input a request could hit once (the kernels' build and
        cuDNN's algorithm search happen there): both canvas orientations, of
        those an artifact has, and, when micro-batching, every batch size a
        group can take."""
        sizes = [1]
        while self._batcher is not None and sizes[-1] < self.batch_size:
            sizes.append(min(sizes[-1] * 2, self.batch_size))
        wait = None
        if self._batcher is not None:  # let the warm-up groups fill completely
            wait, self._batcher._wait_s = self._batcher._wait_s, 1.0
        try:
            lo, hi = sorted(self.tcfg.canvas)
            for hh, ww in ((lo, hi), (hi, lo)):
                if self._canvases is not None and (hh, ww) not in self._canvases:
                    continue
                img = np.zeros((hh, ww, 3), np.float32)
                for k in sizes:
                    if k == 1:
                        self.detect_array(img)
                    else:  # k concurrent requests make one group of k
                        with cf.ThreadPoolExecutor(k) as pool:
                            list(pool.map(self.detect_array, [img] * k))
        finally:
            if wait is not None:
                self._batcher._wait_s = wait
        return self

    def close(self):
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None


def _make_handler(service: DetectionService, metadata: dict):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/metadata":
                self._reply(200, metadata)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path"})
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                dets = service.detect_bytes(data)
            except Exception as e:  # undecodable input, shape errors, ...
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, {"detections": dets})

        def log_message(self, fmt, *args):  # quiet: the service logs itself
            pass

    return Handler


class DetectionServer:
    """Threaded HTTP server over a DetectionService."""

    def __init__(self, service: DetectionService, host: str = "0.0.0.0",
                 port: int = 8080, metadata: Optional[dict] = None):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(service, metadata or {}))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
