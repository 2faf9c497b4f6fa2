"""TPU.HOST_TRANSFER_UINT8 in unit_tpu_torch against unit_tpu, on the CPU.

The twins of tests/test_host_uint8.py: the stream loaders round a batch's
images to uint8 (at most 0.5 off the f32 wire, 4x fewer bytes to upload),
equal to unit_tpu's uint8 batches bit for bit; ``WSRCNN.preprocess`` casts
uint8 to f32 on the device, as unit_tpu's does; the config threads through
``TransformConfig.train_from_cfg``.  Beyond them: a uint8 batch keeps its
dtype through the trainer's upload, and the service's uint8 request wire
submits unit_tpu's canvases and gives its detections, at batch 1 and
micro-batched.
"""

import concurrent.futures as cf
import dataclasses
import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_serving import (  # noqa: F401  (fixtures)
    BATCH_BOX_ATOL, BATCH_BOX_RTOL, BATCH_SCORE_ATOL, BATCH_SCORE_RTOL, NAMES, image, pair,
    two_threads,
)
from tests.test_torch_slice import assert_same_detections
from unit_tpu.data import StreamLoader as JStreamLoader
from unit_tpu.data import TransformConfig as JTransformConfig
from unit_tpu.serving import DetectionService as JDetectionService
from unit_tpu_torch.data.loader import StreamLoader
from unit_tpu_torch.data.transforms import TransformConfig
from unit_tpu_torch.engine.train import TrainerNoMeta
from unit_tpu_torch.serving import DetectionService

_KEYS = ("image", "image_size", "gt_boxes", "gt_classes", "gt_valid")


def _fake_image_loader(rec):
    rng = np.random.RandomState(int(rec["image_id"][2:]) + 7)
    return (rng.rand(rec["height"], rec["width"], 3) * 255).astype(np.float32)


def _records(n=8):
    return [{"image_id": f"im{i}", "file_name": f"/nonexistent/im{i}.png",
             "height": (100, 140)[i % 2], "width": (140, 100)[i % 2],
             "annotations": [{"bbox": [10.0 + i, 12.0, 60.0 + i, 50.0], "category_id": i % 5}]}
            for i in range(n)]


def _loaders(host_uint8: bool, seed=3):
    kw = dict(min_sizes=(64, 80), max_size=128, canvas=(96, 128), flip=True, max_gt=5,
              host_uint8=host_uint8)
    return (StreamLoader(_records(), TransformConfig(**kw), 2, _KEYS, seed=seed,
                         image_loader=_fake_image_loader),
            JStreamLoader(_records(), JTransformConfig(**kw), 2, _KEYS, seed=seed,
                          training=True, image_loader=_fake_image_loader))


def test_uint8_wire_matches_rounded_float_wire():
    (t8, j8), (tf, _) = _loaders(True), _loaders(False)
    for b8, jb8, bf in itertools.islice(zip(iter(t8), iter(j8), iter(tf)), 4):
        assert bf["image"].dtype == np.float32 and b8["image"].dtype == np.uint8
        np.testing.assert_array_equal(
            b8["image"], np.clip(np.rint(bf["image"]), 0, 255).astype(np.uint8))
        for k in _KEYS:  # unit_tpu's uint8 batch, bit for bit
            assert b8[k].dtype == jb8[k].dtype
            np.testing.assert_array_equal(b8[k], jb8[k], err_msg=k)
        for k in _KEYS[1:]:  # only the image changes representation
            np.testing.assert_array_equal(b8[k], bf[k])


def test_preprocess_accepts_uint8(pair):
    _, jmodel, params, tmodel = pair
    imgs8 = np.random.RandomState(0).randint(0, 256, (1, 64, 96, 3), np.uint8)
    with torch.inference_mode():
        outs8 = tmodel.preprocess(torch.as_tensor(imgs8))
        outsf = tmodel.preprocess(torch.as_tensor(imgs8, dtype=torch.float32))
    assert outs8.dtype == outsf.dtype == torch.float32
    torch.testing.assert_close(outs8, outsf, rtol=0, atol=0)
    want = jmodel.apply({"params": params}, jnp.asarray(imgs8), method=type(jmodel).preprocess)
    np.testing.assert_array_equal(outs8.numpy(), np.asarray(want))


def test_config_threads_through():
    from unit_tpu.config import get_cfg as jget_cfg
    from unit_tpu_torch.config import get_cfg

    cfg, jcfg = get_cfg(), jget_cfg()
    assert cfg.TPU.HOST_TRANSFER_UINT8 is False  # the default keeps the f32 wire
    cfg.TPU.HOST_TRANSFER_UINT8 = jcfg.TPU.HOST_TRANSFER_UINT8 = True
    t, j = TransformConfig.train_from_cfg(cfg), JTransformConfig.train_from_cfg(jcfg)
    assert t.host_uint8 is True and dataclasses.asdict(t)["host_uint8"] is True
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the evaluation's loader keeps the f32 wire, as unit_tpu's does
    assert TransformConfig.test_from_cfg(cfg).host_uint8 is False


def test_a_uint8_batch_keeps_its_dtype_through_the_upload():
    batch = next(iter(_loaders(True)[0]))
    host = {k: torch.from_numpy(v) for k, v in batch.items()}  # what pin_batch hands out
    fake = types.SimpleNamespace(device=torch.device("cpu"))
    up = TrainerNoMeta._to_device(fake, host)
    assert up["image"].dtype == torch.uint8
    assert torch.equal(up["image"], torch.from_numpy(batch["image"]))


@pytest.fixture(scope="module")
def services(pair):
    """(port, unit_tpu) services on the uint8 wire."""
    cfg, jmodel, params, tmodel = pair
    cfg8 = cfg.clone()
    cfg8.TPU.HOST_TRANSFER_UINT8 = True
    return (DetectionService(cfg8, tmodel, class_names=NAMES),
            JDetectionService(cfg8, model=jmodel, params=params, class_names=NAMES), cfg8)


@pytest.mark.parametrize("shape", [(50, 70), (70, 50)])
def test_served_uint8_requests_equal_unit_tpus(services, shape, monkeypatch):
    svc, jsvc, _ = services
    assert svc.uint8_wire and jsvc.uint8_wire
    seen = {}
    for name, s in (("port", svc), ("unit_tpu", jsvc)):
        real = s._predict

        def spy(images, sizes, real=real, name=name):
            seen[name] = np.array(images)
            return real(images, sizes)

        monkeypatch.setattr(s, "_predict", spy)
    img = image(shape[0] + 11, shape)
    got, want = svc.detect_array(img), jsvc.detect_array(img)
    assert seen["port"].dtype == seen["unit_tpu"].dtype == np.uint8
    np.testing.assert_array_equal(seen["port"], seen["unit_tpu"])
    assert_same_detections(got, want)


def test_micro_batched_uint8_requests_equal_batch_1(pair, services):
    _, _, _, tmodel = pair
    single, _, cfg8 = services
    imgs = [image(30 + i, (50, 70)) for i in range(4)]
    want = [single.detect_array(x) for x in imgs]
    svc = DetectionService(cfg8, tmodel, class_names=NAMES, batch_size=4, batch_wait_ms=200)
    dtypes = []
    inner = svc._batcher._predict
    svc._batcher._predict = lambda i, s: (dtypes.append(i.dtype), inner(i, s))[1]
    try:
        with cf.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(svc.detect_array, imgs))
    finally:
        svc.close()
    assert dtypes and set(dtypes) == {np.dtype(np.uint8)} and len(dtypes) < 4
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for dg, dw in zip(g, w):
            assert dg["class_id"] == dw["class_id"]
            np.testing.assert_allclose(dg["box"], dw["box"], rtol=BATCH_BOX_RTOL,
                                       atol=BATCH_BOX_ATOL)
            np.testing.assert_allclose(dg["score"], dw["score"], rtol=BATCH_SCORE_RTOL,
                                       atol=BATCH_SCORE_ATOL)
