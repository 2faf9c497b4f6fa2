"""unit_tpu_torch.serving's service, micro-batcher and HTTP server, against
unit_tpu's on shared weights.

Both packages build the flagship recipe cut to the size of
tests/test_serving.py::_serving_cfg (test sizes 64/96: 64x96 and 96x64
canvases) at depth 26 with narrow widths, in f32; random flax weights go
through load_jax_params.  Detections of the two services agree to the bounds
of tests/test_torch_slice.py (equal counts and classes, boxes within 0.05 px,
scores within 2e-3).  The port's own micro-batched results are held to its
batch-1 results with the bounds of tests/test_serving.py:139-142 (boxes 1e-2
px, scores 1e-4), as unit_tpu's are.
"""

import concurrent.futures as cf
import io
import json
import os
import runpy
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_slice import assert_same_detections
from unit_tpu.config import get_cfg
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.serving import DetectionService as JDetectionService
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.serving import DetectionServer, DetectionService
from unit_tpu_torch.serving.server import _STOP, _MicroBatcher

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP = REPO / "configs" / "VOC" / "VOC-RCNN-101-C4-split1.yaml"
# the flagship at the tiny serving size (tests/test_serving.py::_serving_cfg)
TINY_OPTS = ["MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
             "MODEL.RPN.PRE_NMS_TOPK_TEST", "200", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
             "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
             "TPU.MAX_GT_BOXES", "10", "TPU.COMPUTE_DTYPE", "float32"]
NAMES = [f"c{i}" for i in range(20)]
BATCH_BOX_ATOL, BATCH_BOX_RTOL = 1e-2, 1e-4
BATCH_SCORE_ATOL, BATCH_SCORE_RTOL = 1e-4, 1e-3


def tiny_cfg():
    cfg = get_cfg()
    cfg.merge_from_file(str(FLAGSHIP))
    cfg.merge_from_list(TINY_OPTS)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs several such files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_cfg()
    jmodel = JWSRCNN(mc=JModelConfig.from_cfg(cfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
                            jnp.asarray([[64.0, 96.0]]))
    params = randomize_params(variables["params"], seed=3)
    tmodel = WSRCNN(ModelConfig.from_cfg(cfg)).eval()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return cfg, jmodel, params, tmodel


@pytest.fixture(scope="module")
def jservice(pair):
    cfg, jmodel, params, _ = pair
    return JDetectionService(cfg, model=jmodel, params=params, class_names=NAMES)


def image(seed, shape):
    return np.random.RandomState(seed).uniform(0, 255, shape + (3,)).astype(np.float32)


def png_bytes(rgb):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb.astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def assert_in_frame(dets, h, w):
    for d in dets:
        x1, y1, x2, y2 = d["box"]
        assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h, d


@pytest.mark.parametrize("shape", [(50, 70), (70, 50)])  # both canvas orientations
def test_detect_array_matches_unit_tpu(pair, jservice, shape):
    cfg, _, _, tmodel = pair
    img = image(shape[0], shape)
    got = DetectionService(cfg, tmodel, class_names=NAMES).detect_array(img)
    assert_same_detections(got, jservice.detect_array(img))
    assert all(d["class_name"] == NAMES[d["class_id"]] for d in got)
    assert_in_frame(got, *shape)


def test_detect_bytes_png_matches_unit_tpu(pair, jservice):
    """A PNG decodes through PIL in both packages (unit_tpu's C decoder takes
    JPEGs only): the same frame, the same detections."""
    cfg, _, _, tmodel = pair
    data = png_bytes(np.random.RandomState(4).rand(72, 54, 3) * 255)  # portrait
    got = DetectionService(cfg, tmodel).detect_bytes(data)
    assert_same_detections(got, jservice.detect_bytes(data))
    assert_in_frame(got, 72, 54)


def test_microbatch_matches_single(pair):
    """batch_size=4 results equal batch_size=1 results per image, with a
    padded group and mixed orientations (tests/test_serving.py:103-147)."""
    cfg, _, _, tmodel = pair
    single = DetectionService(cfg, tmodel, class_names=NAMES)
    batched = DetectionService(cfg, tmodel, class_names=NAMES, batch_size=4,
                               batch_wait_ms=60.0)
    assert isinstance(batched._batcher, _MicroBatcher)
    calls = []
    inner = batched._batcher._predict
    batched._batcher._predict = lambda i, s: (calls.append(i.shape[0]), inner(i, s))[1]
    imgs = [image(10 + i, (50, 70)) for i in range(3)] + [image(13, (70, 50))]
    with cf.ThreadPoolExecutor(4) as pool:
        got = list(pool.map(batched.detect_array, imgs))
    want = [single.detect_array(im) for im in imgs]
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for dg, dw in zip(g, w):
            assert dg["class_id"] == dw["class_id"]
            np.testing.assert_allclose(dg["box"], dw["box"], rtol=BATCH_BOX_RTOL,
                                       atol=BATCH_BOX_ATOL)
            np.testing.assert_allclose(dg["score"], dw["score"], rtol=BATCH_SCORE_RTOL,
                                       atol=BATCH_SCORE_ATOL)
    # power-of-two device batches, fewer calls than requests (the three
    # landscape requests arrived within the 60 ms window)
    assert all(c in (1, 2, 4) for c in calls)
    assert len(calls) < 4
    batched.close()
    assert batched._batcher is None


def test_warmup_runs_every_batch_size(pair):
    cfg, _, _, tmodel = pair
    svc = DetectionService(cfg, tmodel, batch_size=4)
    shapes = []
    inner = svc._batcher._predict
    svc._batcher._predict = lambda i, s: (shapes.append(i.shape[:3]), inner(i, s))[1]
    svc.warmup()
    svc.close()
    assert sorted(shapes) == sorted((b, h, w) for h, w in ((64, 96), (96, 64))
                                    for b in (1, 2, 4))


def test_group_keeps_the_requests_dtype():
    """The group is stacked in the requests' own dtype (unit_tpu forces f32,
    ROADMAP R1): the model casts on the device."""
    seen = []

    def predict(images, sizes):
        seen.append((images.dtype, images.shape, sizes.dtype))
        return _fake_detections(images.shape[0])

    mb = _MicroBatcher(predict, batch_size=2, wait_ms=1.0)
    try:
        out = mb.submit(np.full((4, 6, 3), 7, np.uint8), np.asarray([4, 6], np.float32))
    finally:
        mb.close()
    assert seen == [(np.uint8, (1, 4, 6, 3), np.float32)]
    assert set(out) == {"boxes", "scores", "classes", "valid"}
    assert out["classes"].dtype == np.int32 and out["valid"].dtype == bool


def _fake_detections(b, d=3):
    from unit_tpu_torch.structures.instances import Detections

    return Detections(boxes=torch.ones(b, d, 4), scores=torch.full((b, d), 0.5),
                      classes=torch.arange(d).expand(b, d), valid=torch.ones(b, d, dtype=torch.bool))


def test_predict_error_reaches_every_waiter():
    started = threading.Event()

    def boom(images, sizes):
        started.set()
        raise RuntimeError("simulated device failure")

    mb = _MicroBatcher(boom, batch_size=4, wait_ms=200.0)
    try:
        img, size = np.zeros((4, 4, 3), np.float32), np.ones(2, np.float32)
        with cf.ThreadPoolExecutor(3) as pool:
            futures = [pool.submit(mb.submit, img, size) for _ in range(3)]
            for f in futures:
                with pytest.raises(RuntimeError, match="simulated device failure"):
                    f.result(timeout=30)
    finally:
        mb.close()
    assert started.is_set()


def test_microbatcher_close_fails_stranded_requests():
    """A request behind the stop sentinel is failed, not left blocking its
    submit() caller (tests/test_serving.py:302-321)."""
    mb = _MicroBatcher(lambda img, sz: None, batch_size=2, wait_ms=1.0)
    mb._q.put(_STOP)
    mb._thread.join(timeout=5)
    assert not mb._thread.is_alive()
    item = {"image": np.zeros((4, 4, 3), np.float32), "size": np.ones(2, np.float32),
            "event": threading.Event()}
    mb._q.put(item)
    mb.close()
    assert item["event"].is_set()
    assert isinstance(item.get("error"), RuntimeError)
    assert not mb._fetch_thread.is_alive()


def test_microbatcher_close_answers_the_group_in_flight():
    """close() while the dispatcher is inside a predict call that outlasts
    any join timeout: the group still gets its outputs, as the fetch thread
    stops only after the dispatcher's last group, and close() returns."""
    entered, release = threading.Event(), threading.Event()

    def slow(images, sizes):
        entered.set()
        release.wait(60)
        return _fake_detections(images.shape[0])

    mb = _MicroBatcher(slow, batch_size=2, wait_ms=1.0)
    img, size = np.zeros((4, 4, 3), np.float32), np.ones(2, np.float32)
    got = {}
    request = threading.Thread(target=lambda: got.update(out=mb.submit(img, size)), daemon=True)
    request.start()
    assert entered.wait(30)
    closing = threading.Thread(target=mb.close, daemon=True)
    closing.start()
    time.sleep(6.0)  # past the 5 s join timeout of unit_tpu's close()
    assert closing.is_alive()  # close() waits for the group in flight
    release.set()
    closing.join(30)
    request.join(30)
    assert not closing.is_alive() and not request.is_alive()
    assert set(got["out"]) == {"boxes", "scores", "classes", "valid"}
    assert not mb._thread.is_alive() and not mb._fetch_thread.is_alive()


def _http(base, path, data=None):
    req = urllib.request.Request(base + path, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_server_end_to_end(pair):
    cfg, _, _, tmodel = pair
    svc = DetectionService(cfg, tmodel, class_names=NAMES, batch_size=2)
    server = DetectionServer(svc, host="127.0.0.1", port=0,
                             metadata={"flavor": "test"}).start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert _http(base, "/healthz") == (200, {"status": "ok"})
        assert _http(base, "/metadata") == (200, {"flavor": "test"})
        payloads = [png_bytes(np.random.RandomState(20 + i).rand(*s, 3) * 255)
                    for i, s in enumerate(((48, 72), (72, 48), (50, 70)))]
        # one request alone takes a batch-1 call, as detect_bytes alone does:
        # the same JSON
        code, body = _http(base, "/predict", payloads[0])
        assert code == 200 and body == {"detections": svc.detect_bytes(payloads[0])}
        # concurrent requests may share a call: the batch bounds
        with cf.ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(lambda p: _http(base, "/predict", p), payloads))
        for (code, body), p in zip(replies, payloads):
            want = svc.detect_bytes(p)
            assert code == 200 and len(body["detections"]) == len(want)
            for dg, dw in zip(body["detections"], want):
                assert dg["class_name"] == dw["class_name"]
                np.testing.assert_allclose(dg["box"], dw["box"], rtol=BATCH_BOX_RTOL,
                                           atol=BATCH_BOX_ATOL)
                np.testing.assert_allclose(dg["score"], dw["score"], rtol=BATCH_SCORE_RTOL,
                                           atol=BATCH_SCORE_ATOL)
        code, body = _http(base, "/predict", b"not an image")
        assert code == 400 and body["error"]
        assert _http(base, "/nowhere")[0] == 404
        assert _http(base, "/nowhere", b"x")[0] == 404
    finally:
        server.shutdown()
    assert svc._batcher is None


def test_with_proposals_artifact_rejected(pair):
    """A precomputed-proposal artifact takes inputs no request carries: the
    service refuses it up front (tests/test_serving.py:289-299)."""
    exported = types.SimpleNamespace(meta={"with_proposals": True})
    with pytest.raises(ValueError, match="with_proposals"):
        DetectionService(pair[0], exported=exported)
    with pytest.raises(ValueError, match="exactly one"):
        DetectionService(pair[0])


def test_bench_serving_keeps_the_yaml_values():
    """bench_serving_torch.py takes the config as its YAML gives it and a
    flag only when passed (unit_tpu's bench overrides NUM_CLASSES, depth and
    test sizes, ROADMAP R2)."""
    bench = runpy.run_path(str(REPO / "scripts" / "bench_serving_torch.py"))
    coco = str(REPO / "configs" / "COCO" / "COCO-RCNN-50-C4-split1-segm.yaml")
    yaml_cfg = get_cfg()
    yaml_cfg.merge_from_file(coco)
    args = types.SimpleNamespace(
        config_file=coco, depth=None, min_size=None, max_size=None, weights="",
        uint8_wire=False, opts=[])
    cfg = bench["bench_cfg"](args)
    for key in ("MODEL.ROI_HEADS.NUM_CLASSES", "MODEL.RESNETS.DEPTH", "INPUT.MIN_SIZE_TEST",
                "INPUT.MAX_SIZE_TEST", "MODEL.MASK_ON"):
        a, b = cfg, yaml_cfg
        for part in key.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert a == b, key
    assert cfg.MODEL.ROI_HEADS.NUM_CLASSES == 80
    args.depth, args.min_size = 101, 640
    cfg = bench["bench_cfg"](args)
    assert (cfg.MODEL.RESNETS.DEPTH, cfg.INPUT.MIN_SIZE_TEST) == (101, 640)
    assert cfg.INPUT.MAX_SIZE_TEST == yaml_cfg.INPUT.MAX_SIZE_TEST
    assert cfg.TPU.HOST_TRANSFER_UINT8 is False
    args.uint8_wire = True  # --uint8-wire
    assert bench["bench_cfg"](args).TPU.HOST_TRANSFER_UINT8 is True


def test_serve_cli_needs_the_card_unless_asked():
    serve = runpy.run_path(str(REPO / "scripts" / "serve_torch.py"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve["main"](["--config-file", str(FLAGSHIP), "--no-warmup"])


def test_serve_cli_on_the_cpu(tmp_path):
    """scripts/serve_torch.py --device cpu as a user starts it: it prints
    its bound port, answers /healthz and a POST, and exits 0 on SIGTERM."""
    cmd = [sys.executable, str(REPO / "scripts" / "serve_torch.py"), "--config-file",
           str(FLAGSHIP), "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
           "--no-warmup", *TINY_OPTS, "MODEL.WEIGHTS", "", "OUTPUT_DIR", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=tmp_path, env=env)
    try:
        lines = []
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on "):
                break
        assert lines and lines[-1].startswith("serving on 127.0.0.1:"), "".join(lines)
        base = "http://127.0.0.1:" + lines[-1].strip().rsplit(":", 1)[1]
        assert _http(base, "/healthz") == (200, {"status": "ok"})
        code, body = _http(base, "/predict", png_bytes(np.full((40, 60, 3), 128)))
        assert code == 200 and isinstance(body["detections"], list)
        assert _http(base, "/metadata")[1]["device"] == "cpu"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "signal 15: shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
