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
    assert tmc.bn_act_impl == "auto"


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
    images, sizes = images_and_sizes()
    boxes = torch.tensor([[[10.0, 10.0, 90.0, 120.0], [40.0, 30.0, 200.0, 150.0],
                           [0.0, 0.0, 0.0, 0.0]]]).expand(2, -1, -1)
    valid = torch.tensor([[True, True, False]]).expand(2, -1)
    # TTA with precomputed proposals is ported (tests/test_torch_dock_slice.py): it runs
    var = {"image": torch.as_tensor(images[:1]), "image_size": torch.as_tensor(sizes[:1]),
           "scale": 1.0, "flip": False}
    with torch.inference_mode():
        dets = tmodel.predict_tta(var["image"], var["image_size"], [var],
                                  proposal_boxes=boxes[:1], proposal_valid=valid[:1])
    assert dets.boxes.shape[0] == 1 and torch.isfinite(dets.boxes).all()
    # the dock suite's model and VGG16 (their backbones with their fc heads
    # and ROIPool), precomputed proposals and the weak regression branch are
    # ported (tests/test_torch_dock*.py): they build and predict, from given
    # proposals and from the RPN's
    for opts in (["MODEL.BACKBONE.NAME", "VGG", "MODEL.ROI_BOX_HEAD.NAME", "VGGConvFCHead",
                  "MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIPool",
                  "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "2"],
                 ["MODEL.BACKBONE.NAME", "VGG_CNN_F", "MODEL.ROI_BOX_HEAD.NAME", "VGGCNNFBoxHead",
                  "MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIPool",
                  "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "6"],
                 ["MODEL.LOAD_PROPOSALS", "True"],
                 ["MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.REGRESSION_BRANCH", "True"]):
        cfg = small_flagship_cfg()
        cfg.merge_from_list(opts)
        model = WSRCNN(ModelConfig.from_cfg(cfg), torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode():
            for given in ((boxes, valid), ()):
                d = model.predict(torch.as_tensor(images), torch.as_tensor(sizes), *given)
                assert d.boxes.shape[0] == 2 and torch.isfinite(d.scores).all(), opts
    # the pairs no recipe ships are ported: a Res5 head over a VGG backbone, a
    # VGG head over ResNet-C4 or InceptionResNetV2 (over 2 x 2 maps: fc6 over
    # 14 x 14 x 1088 would hold 0.9 G weights) and the meta head over
    # VGG-CNN-F each build over the backbone's width and predict; the head
    # each brings in takes unit_tpu's flax tree of that head over that width
    # strictly and computes what it computes (the whole models against
    # unit_tpu's: tests/test_torch_pairs.py, tests/test_torch_pair_meta.py).
    # Masks over a VGG fc head, which keeps no map, fail in both packages
    from unit_tpu.models import box_heads as jbh
    from unit_tpu.models import mask_head as jmask
    from unit_tpu.models import resnet as jres

    vgg_f = ["MODEL.BACKBONE.NAME", "VGG_CNN_F", "MODEL.ROI_BOX_HEAD.NAME", "VGGCNNFBoxHead",
             "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "2"]
    small = ["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "2"]
    res5 = jres.Res5(depth=26, res2_out_channels=16)
    for opts, head, jhead, pooled in (
            (["MODEL.BACKBONE.NAME", "VGG"], "box_head", res5, (14, 512)),
            (["MODEL.BACKBONE.NAME", "VGG_CNN_F"], "box_head", res5, (14, 256)),
            (["MODEL.ROI_BOX_HEAD.NAME", "VGGCNNFBoxHead", *small], "box_head",
             jbh.VGGCNNFBoxHead(), (2, 64)),
            (["MODEL.BACKBONE.NAME", "InceptionResNetV2", "MODEL.ROI_BOX_HEAD.NAME",
              "VGGConvFCHead", *small], "box_head", jbh.VGGConvFCHead(), (2, 1088)),
            (vgg_f + ["MODEL.ROI_HEADS.NAME", "WSROIHead"], "visual_attention.meta_box_head",
             res5, (2, 256)),
            (vgg_f + ["MODEL.MASK_ON", "True"], None, None, None)):
        cfg = small_flagship_cfg()
        cfg.merge_from_list(opts + ["MODEL.RESNETS.RES2_OUT_CHANNELS", "16"])  # cheap inits
        if head is None:
            # unit_tpu's mask head over the VGG head's flat [N, 4096] features
            with pytest.raises(Exception) as failure:
                jmask.MaskRCNNConvUpsampleHead(num_classes=20).init(
                    jax.random.PRNGKey(0), jnp.zeros((2, 4096)))
            assert "mask_head" in "".join(str(f) for f in failure.traceback)
            with pytest.raises(ValueError, match="has no spatial map|has none"):
                WSRCNN(ModelConfig.from_cfg(cfg))
            continue
        model = WSRCNN(ModelConfig.from_cfg(cfg), torch.Generator().manual_seed(0)).eval()
        module = model.get_submodule(head)
        p, c = pooled
        x = np.random.RandomState(c).randn(3, p, p, c).astype(np.float32)
        tree = jax.tree.map(np.asarray, randomize_params(jax.jit(jhead.init)(
            jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed=3))
        load_jax_params(module, tree)
        want = np.asarray(jax.jit(jhead.apply)({"params": tree}, jnp.asarray(x)))
        with torch.inference_mode():
            got = module(torch.as_tensor(x)).float().numpy()
            probs, bbox, props, _ = model.predict_raw(torch.as_tensor(images[:1]),
                                                      torch.as_tensor(sizes[:1]))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=str(opts))
        assert int(props.valid.sum()) > 0 and torch.isfinite(probs).all(), opts
        assert torch.isfinite(bbox).all() and probs.shape[-1] == 21, opts
    # the meta ROI heads are ported (tests/test_torch_meta.py): they build
    # the visual attention head
    cfg = small_flagship_cfg()
    cfg.merge_from_list(["MODEL.ROI_HEADS.NAME", "WSROIHead"])
    assert WSRCNN(ModelConfig.from_cfg(cfg)).visual_attention.mode == "mean"
    # PCL and the weak-only family are ported (tests/test_torch_pcl.py,
    # tests/test_torch_weak_only.py): they build
    for key, value in [("MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.TYPE", "PCL"),
                       ("MODEL.META_ARCHITECTURE", "WeakRCNN"),
                       ("MODEL.META_ARCHITECTURE", "WeaklySupervisedRCNNRPN")]:
        cfg = small_flagship_cfg()
        cfg.merge_from_list([key, value])
        assert WSRCNN(ModelConfig.from_cfg(cfg)).mc.meta_architecture in (
            "WeaklySupervisedRCNNNoMeta", "WeakRCNN", "WeaklySupervisedRCNNRPN")
    # masks are ported (tests/test_torch_mask.py, tests/test_torch_coco_slice.py)
    cfg = small_flagship_cfg()
    cfg.merge_from_list(["MODEL.MASK_ON", "True",
                         "MODEL.ROI_BOX_HEAD.NAME", "Res5BoxHeadWithMask"])
    assert isinstance(WSRCNN(ModelConfig.from_cfg(cfg)).mask_head.deconv, torch.nn.ConvTranspose2d)
    # fine-tuning is ported (tests/test_torch_finetune.py): its heads build
    cfg = small_flagship_cfg()
    cfg.merge_from_list(["MODEL.ROI_HEADS.FAST_RCNN.NAME", "SupervisedDetectorOutputsFineTune",
                         "MODEL.ROI_HEADS.FAST_RCNN.WEAK_DETECTOR.NAME", "WeakDetectorOutputsFT"])
    ft = WSRCNN(ModelConfig.from_cfg(cfg))
    assert ft.mc.finetune and ft.mc.weak_detector_finetune
    assert not ft.supervised.cls_score_ft.weight.any()
    # TPU.FOLD_BN_AT_EVAL is ported (tests/test_torch_bn_fold.py), and so are
    # the micro-batcher, encoded requests, the HTTP server and the exported
    # artifacts (tests/test_torch_serving.py, tests/test_torch_export.py): a
    # micro-batching service builds and closes; so is the uint8 request wire
    # (tests/test_torch_host_uint8.py): a service on it submits uint8
    # canvases and answers
    cfg = small_flagship_cfg()
    svc = DetectionService(cfg, tmodel, batch_size=4)
    assert svc._batcher is not None
    svc.close()
    cfg.TPU.HOST_TRANSFER_UINT8 = True
    for batch_size in (1, 4):
        svc = DetectionService(cfg, tmodel, batch_size=batch_size)
        dtypes = []
        owner = svc if svc._batcher is None else svc._batcher
        inner = owner._predict

        def spy(images, sizes, inner=inner):
            dtypes.append(images.dtype)
            return inner(images, sizes)

        owner._predict = spy
        assert svc.uint8_wire and isinstance(
            svc.detect_array(np.random.RandomState(batch_size).rand(50, 70, 3) * 255), list)
        svc.close()
        assert dtypes == [np.dtype(np.uint8)]
