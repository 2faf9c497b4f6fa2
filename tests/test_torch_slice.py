"""The serving slice end to end: unit_tpu_torch vs unit_tpu on shared weights.

Both packages build the flagship recipe (configs/VOC/VOC-RCNN-101-C4-split1.yaml)
cut to depth 26, narrow widths (RES2_OUT_CHANNELS 64), a 160x224 canvas and
64 proposals, in f32.  Random flax weights go through load_jax_params.

Bounds (those of tests/test_full_graph_torch_parity.py:373,413,415): equal
proposal counts, proposal boxes within 0.05 px, probabilities and box deltas
within 2e-3.  The two stacks run the same f32 math with different summation
orders; NMS decisions are identical unless an IoU sits within float noise of
its threshold.  Final detections agree to the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from unit_tpu.config import get_cfg
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.serving import DetectionService as JDetectionService
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.serving import DetectionService

BOX_TOL = 0.05
PROB_TOL = 2e-3


def small_flagship_cfg():
    cfg = get_cfg()
    cfg.merge_from_file("configs/VOC/VOC-RCNN-101-C4-split1.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", "26", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "600", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
        "INPUT.MIN_SIZE_TEST", "160", "INPUT.MAX_SIZE_TEST", "224",
        "TPU.COMPUTE_DTYPE", "float32",
    ])
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = small_flagship_cfg()
    jmodel = JWSRCNN(mc=JModelConfig.from_cfg(cfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 160, 224, 3)),
                            jnp.asarray([[160.0, 224.0]]))
    params = randomize_params(variables["params"], seed=3)
    tmodel = WSRCNN(ModelConfig.from_cfg(cfg)).eval()
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return cfg, jmodel, params, tmodel


def images_and_sizes():
    rng = np.random.RandomState(7)
    images = rng.uniform(0, 255, (2, 160, 224, 3)).astype(np.float32)
    images[1, 150:] = 0.0  # second image: content 150 x 200 in the canvas
    images[1, :, 200:] = 0.0
    return images, np.asarray([[160, 224], [150, 200]], np.float32)


def test_config_distils_the_same_fields(pair):
    cfg, jmodel, _, tmodel = pair
    jmc, tmc = jmodel.mc, tmodel.mc
    for f in ("depth", "res2_out_channels", "num_classes", "base_ids", "novel_ids",
              "multi_box_head", "pooler_resolution", "sampling_ratio", "oicr_iter",
              "regression_branch", "oicr_regression_branch", "pixel_mean", "pixel_std",
              "normalize_images", "compute_dtype"):
        assert getattr(tmc, f) == getattr(jmc, f), f
    assert tuple(tmc.rpn.sizes) == tuple(jmc.rpn.sizes)
    assert tmc.rpn.post_nms_topk_test == jmc.rpn.post_nms_topk_test == 64
    assert tmc.frcnn == type(tmc.frcnn)(*[getattr(jmc.frcnn, f) for f in tmc.frcnn._fields])
    assert tmc.sim == type(tmc.sim)(*jmc.sim)
    assert tmc.roi_align_impl == "auto" and tmc.nms_impl == "auto"


def test_predict_raw_matches(pair):
    _, jmodel, params, tmodel = pair
    images, sizes = images_and_sizes()
    probs_j, bbox_j, props_j, feats_j = jmodel.apply(
        {"params": params}, jnp.asarray(images), jnp.asarray(sizes),
        method=JWSRCNN.predict_raw)
    with torch.inference_mode():
        probs_t, bbox_t, props_t, feats_t = tmodel.predict_raw(
            torch.as_tensor(images), torch.as_tensor(sizes))
    assert feats_t.shape == feats_j.shape
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-3, rtol=1e-4)
    valid_j = np.asarray(props_j.valid)
    for i in range(2):
        n = int(valid_j[i].sum())
        assert n == int(props_t.valid[i].sum()) and n >= 32, (i, n)
        np.testing.assert_array_equal(props_t.valid[i].numpy(), valid_j[i])
        db = np.abs(props_t.boxes[i, :n].numpy() - np.asarray(props_j.boxes)[i, :n]).max()
        assert db < BOX_TOL, (i, db)
        dp = np.abs(probs_t[i, :n].numpy() - np.asarray(probs_j)[i, :n]).max()
        assert dp < PROB_TOL, (i, dp)
        dd = np.abs(bbox_t[i, :n].numpy() - np.asarray(bbox_j)[i, :n]).max()
        assert dd < PROB_TOL, (i, dd)


def assert_same_detections(got, want):
    assert len(got) == len(want) > 0
    for w in want:
        match = [g for g in got if g["class_id"] == w["class_id"]
                 and abs(g["score"] - w["score"]) < PROB_TOL
                 and np.abs(np.subtract(g["box"], w["box"])).max() < BOX_TOL]
        assert match, f"no counterpart for {w}"


def test_predict_matches(pair):
    _, jmodel, params, tmodel = pair
    images, sizes = images_and_sizes()
    dj = jmodel.apply({"params": params}, jnp.asarray(images), jnp.asarray(sizes),
                      method=JWSRCNN.predict)
    with torch.inference_mode():
        dt = tmodel.predict(torch.as_tensor(images), torch.as_tensor(sizes))
    for i in range(2):
        def recs(boxes, scores, classes, valid):
            return [{"box": list(boxes[k]), "score": float(scores[k]),
                     "class_id": int(classes[k])} for k in np.flatnonzero(valid)]
        want = recs(*(np.asarray(a)[i] for a in (dj.boxes, dj.scores, dj.classes, dj.valid)))
        got = recs(*(a[i].numpy() for a in (dt.boxes, dt.scores, dt.classes, dt.valid)))
        assert_same_detections(got, want)


@pytest.mark.parametrize("shape", [(150, 190), (190, 150)])  # both canvas orientations
def test_detection_service_matches(pair, shape):
    cfg, jmodel, params, tmodel = pair
    image = np.random.RandomState(shape[0]).uniform(0, 255, shape + (3,)).astype(np.float32)
    want = JDetectionService(cfg, model=jmodel, params=params).detect_array(image)
    got = DetectionService(cfg, tmodel).detect_array(image)
    assert_same_detections(got, want)
    for d in got:
        x1, y1, x2, y2 = d["box"]
        assert 0 <= x1 <= x2 <= shape[1] and 0 <= y1 <= y2 <= shape[0]


def test_unported_paths_raise(pair):
    _, _, _, tmodel = pair
    for fn in (tmodel.train_losses, tmodel.predict_tta, tmodel.predict_weak_only):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
    for key, value, item in [("MODEL.MASK_ON", "True", "item 22"),
                             ("MODEL.ROI_HEADS.FAST_RCNN.NAME",
                              "SupervisedDetectorOutputsFineTune", "item 19"),
                             ("MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.REGRESSION_BRANCH",
                              "True", "item 25"),
                             ("MODEL.META_ARCHITECTURE", "WeakRCNN", "item 20")]:
        cfg = small_flagship_cfg()
        cfg.merge_from_list([key, value])
        with pytest.raises(NotImplementedError, match=item):
            WSRCNN(ModelConfig.from_cfg(cfg))
    cfg = small_flagship_cfg()
    cfg.TPU.FOLD_BN_AT_EVAL = True
    with pytest.raises(NotImplementedError, match="FOLD_BN_AT_EVAL"):
        DetectionService(cfg, tmodel)
