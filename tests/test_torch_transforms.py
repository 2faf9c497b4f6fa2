"""Test-time transform and GloVe table in unit_tpu_torch vs unit_tpu.

Both transforms are the same numpy code, so canvases, content sizes, scales
and resized pixels must be identical, not merely close.
"""

import numpy as np
import pytest
import torch
from torch import nn

from unit_tpu.checkpoint.checkpointer import load_glove_embeddings as jload_glove
from unit_tpu.config import get_cfg
from unit_tpu.data import transforms as jtf
from unit_tpu_torch.checkpoint import load_glove_embeddings
from unit_tpu_torch.data import transforms as ttf

FLAGSHIP = "configs/VOC/VOC-RCNN-101-C4-split1.yaml"


@pytest.fixture(scope="module")
def tcfgs():
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    return ttf.TransformConfig.test_from_cfg(cfg), jtf.TransformConfig.test_from_cfg(cfg)


def test_test_config_matches(tcfgs):
    got, want = tcfgs
    assert got.canvas == want.canvas == (800, 1344)
    assert tuple(got.min_sizes) == tuple(want.min_sizes)
    assert got.max_size == want.max_size


# landscape, portrait, square, long-side cap, already at size
@pytest.mark.parametrize("shape", [(375, 500), (500, 375), (333, 333), (100, 1000), (800, 1200)])
def test_prepare_test_image_matches(tcfgs, shape):
    got_cfg, want_cfg = tcfgs
    image = np.random.RandomState(shape[0]).uniform(0, 255, shape + (3,)).astype(np.float32)
    want = jtf.prepare_detection_record({"image_id": "x"}, want_cfg, np.random.RandomState(0),
                                        image=image, training=False)
    got = ttf.prepare_test_image(image, got_cfg)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["image_size"], want["image_size"])
    assert float(got["scale"]) == float(want["scale"])


def test_glove_embeddings_match():
    holder = nn.Module()
    holder.register_buffer("embeddings", torch.zeros(80, 300))
    path = "data/embeddings/glove_mean.npz"
    load_glove_embeddings(holder, path)
    want = jload_glove({"embeddings": np.zeros((80, 300), np.float32)}, path)["embeddings"]
    np.testing.assert_array_equal(holder.embeddings.numpy(), want)
    with pytest.raises(ValueError, match="embeddings"):
        bad = nn.Module()
        bad.register_buffer("embeddings", torch.zeros(20, 300))
        load_glove_embeddings(bad, path)
