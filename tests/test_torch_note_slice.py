"""The note recipe end to end: unit_tpu_torch vs unit_tpu on shared weights.

configs/COCO/COCO-RCNN-50-C4-split1-note.yaml (InceptionResNetV2 +
InceptionResNetHead at their full depth, as unit_tpu's WSRCNN builds them,
80 classes, ROIAlignV2 at 17x17) on a small canvas and RPN top-k, in f32:
one train step's losses and every gradient leaf, predict_raw and predict,
the strict weight conversion both ways, the frozen set, and the map of an
odd canvas.  The modules alone are tests/test_torch_note.py.

Weights: the train step on tests/test_full_graph_torch_parity.py's
randomize_params, as the other slices; predict on He-scaled convolution
kernels and normal(0.1) elsewhere (tests/test_torch_note.py's he_tree):
randomize_params shrinks every convolution 0.4x, and through this depth its
81 class probabilities tie to 1e-7, so its detections are ties.  Under the
He weights, whose activations grow through the 40 residual blocks, f32
rounding differences reach one gradient leaf (a block17 bias) at 5e-3 of
its largest element, beyond the 2e-3 bound the other slices hold: so the
train step keeps randomize_params.

Bounds: tests/test_torch_coco_slice.py's (losses rtol 1e-4, every gradient
within 2e-3 * max|g_jax| + 1e-6, proposals within 0.05 px, probabilities
and deltas within 2e-3, final boxes within 0.05 px and scores within 2e-3,
classes equal).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_full_graph_torch_parity import randomize_params
from tests.test_torch_coco_slice import BOX_TOL, GRAD_ATOL, GRAD_REL, LOSS_RTOL, PROB_TOL
from tests.test_torch_coco_slice import coco_batches
from tests.test_torch_note import he_tree, note_cfgs, param_shapes
from tests.test_torch_note import two_threads  # noqa: F401  (autouse)
from unit_tpu.models import fast_rcnn as jfrcnn
from unit_tpu.models.meta_arch import WSRCNN as JWSRCNN
from unit_tpu.models.meta_arch import ModelConfig as JModelConfig
from unit_tpu.solver.build import is_frozen as jis_frozen
from unit_tpu_torch.checkpoint import load_jax_params
from unit_tpu_torch.checkpoint.jax_params import flatten_tree, flax_leaves, flax_path
from unit_tpu_torch.models import WSRCNN, ModelConfig
from unit_tpu_torch.solver import build_optimizer

H, W = 160, 224
SMALL = [
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "300", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "300", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "4096",          # > 1440 anchors
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "12",      # = 8 proposals + 4 GT slots
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
    "TPU.COMPUTE_DTYPE", "float32",
    # random heads spread their probability over 81 classes
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.02",
]


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def note():
    """unit_tpu's and the port's note model on one seeded flax tree (the
    shapes from jax.eval_shape: nothing is initialised), with each side's
    losses and gradients of one train step (8 proposals an image, in the
    keep-everything sampling regime of tests/test_torch_coco_slice.py) and
    its detections of two images (16 proposals an image), on a 160x224
    canvas (an 8x12 block17 map)."""
    jcfg, tcfg = note_cfgs(*SMALL)
    jm = JWSRCNN(mc=JModelConfig.from_cfg(jcfg))
    shapes = param_shapes(jm, np.zeros((1, H, W, 3), np.float32),
                          np.asarray([[H, W]], np.float32))
    params = randomize_params(shapes, seed=3)
    strong, weak = coco_batches(tcfg)
    del strong["gt_masks"]

    def loss_fn(p):
        losses = jm.apply({"params": p}, jax.random.PRNGKey(3),
                          jax.tree.map(jnp.asarray, strong), jax.tree.map(jnp.asarray, weak),
                          method=JWSRCNN.train_losses)
        return sum(losses.values()), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm = WSRCNN(ModelConfig.from_cfg(tcfg))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    build_optimizer(tcfg, tm)  # the recipe's freezes, as the trainer applies them
    losses_t = tm.train_losses(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in strong.items()},
                               {k: t(v) for k, v in weak.items()})
    torch.stack(list(losses_t.values())).sum().backward()
    grads_t = flax_leaves(tm, grads=True)

    params_he = he_tree(jm, shapes=shapes, seed=3)
    load_jax_params(tm, params_he)
    images = strong["image"].copy()
    images[1, 150:], images[1, :, 200:] = 0.0, 0.0
    sizes = np.asarray([[H, W], [150, 200]], np.float32)

    def predict(p, i, s):
        # JWSRCNN.predict, with its predict_raw's outputs kept
        probs, bbox, props, _ = jm.apply({"params": p}, i, s, method=JWSRCNN.predict_raw)
        dets = jax.vmap(lambda pr, bx, pb, pv, hw: jfrcnn.fast_rcnn_inference_single(
            pr, bx, pb, pv, (hw[0], hw[1]), jm.mc.frcnn))(probs, bbox, props.boxes,
                                                          props.valid, s)
        return (probs, bbox, props), dets

    raw_j, dets_j = jax.tree.map(np.asarray, jax.jit(predict)(
        params_he, jnp.asarray(images), jnp.asarray(sizes)))
    tm.eval()
    with torch.inference_mode():
        raw_t = tm.predict_raw(t(images), t(sizes))
        dets_t = tm.predict(t(images), t(sizes))
    return dict(tm=tm, tcfg=tcfg, jcfg=jcfg, params=params_he,
                losses_j={k: float(v) for k, v in losses_j.items()},
                losses_t={k: float(v.detach()) for k, v in losses_t.items()},
                grads_j=flatten_tree(jax.tree.map(np.asarray, grads_j)),
                grads_t=grads_t, raw_j=raw_j, raw_t=raw_t,
                dets_j=dets_j, dets_t=dets_t)


def test_config_distils_the_same_fields(note):
    jmc, tmc = JModelConfig.from_cfg(note["jcfg"]), note["tm"].mc
    for f in ("backbone_name", "box_head_name", "rpn_conv_dim", "num_classes", "base_ids",
              "novel_ids", "multi_box_head", "pooler_resolution", "pooler_scale",
              "sampling_ratio", "roi_batch_size", "weak_proposal_count", "detector_temp",
              "regression_branch", "pixel_mean", "pixel_std", "normalize_images"):
        assert getattr(tmc, f) == getattr(jmc, f), f
    assert tmc.pixel_mean == (0.5, 0.5, 0.5) and tmc.normalize_images


def test_weights_convert_strictly_both_ways(note):
    """Every flax leaf of the note model lands in a port tensor and comes
    back unchanged through flax_leaves: the asymmetric kernels (1x7, 7x1,
    1x3, 3x1), the head's bias-free branches beside its biased ``up``."""
    tree = flatten_tree(jax.tree.map(np.asarray, note["params"]))
    back = flax_leaves(note["tm"])
    assert set(back) == set(tree) - {"embeddings"}  # the frozen GloVe table is a buffer
    for path, leaf in tree.items():
        if path != "embeddings":
            np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    for path, shape in (("backbone/block17_3/b1_1/kernel", (1, 7, 128, 160)),
                        ("backbone/block17_3/b1_2/kernel", (7, 1, 160, 192)),
                        ("box_head/block8_final/b1_1/kernel", (1, 3, 192, 224)),
                        ("box_head/block8_final/b1_2/kernel", (3, 1, 224, 256)),
                        ("box_head/block8_4/up/bias", (2080,)),
                        ("box_head/conv2d_7b/kernel", (1, 1, 2080, 1536))):
        assert tree[path].shape == shape, path
    assert "box_head/block8_4/b0/bias" not in tree and "backbone/block35_9/b0/bias" in tree
    model = copy.deepcopy(note["tm"])
    cut = jax.tree.map(lambda x: x, jax.tree.map(np.asarray, note["params"]))
    del cut["box_head"]["block8_2"]["b1_1"]
    with pytest.raises(KeyError, match="not in the flax tree"):
        load_jax_params(model, cut)
    cut["box_head"]["block8_2"]["b1_1"] = {"kernel": tree["box_head/block8_2/b1_1/kernel"],
                                           "bias": np.zeros(224, np.float32)}
    with pytest.raises(KeyError, match="no counterpart"):
        load_jax_params(model, cut)


def test_frozen_set_equals_unit_tpus(note):
    """FREEZE_AT 2 freezes backbone/stem and backbone/res2, which match no
    InceptionResNetV2 path: every backbone parameter trains, in both."""
    tm, jcfg = note["tm"], note["jcfg"]
    assert jcfg.MODEL.BACKBONE.FREEZE_AT == note["tcfg"].MODEL.BACKBONE.FREEZE_AT == 2
    paths = list(flatten_tree(jax.tree.map(np.asarray, note["params"])))
    assert {p for p in paths if jis_frozen(p, jcfg)} == {"embeddings"}  # a buffer here
    for name, param in tm.named_parameters():
        path = flax_path(name, param)
        assert path in paths and param.requires_grad == (not jis_frozen(path, jcfg)), path
    assert all(p.requires_grad for p in tm.backbone.parameters())


def test_train_losses_match(note):
    want, got = note["losses_j"], note["losses_t"]
    assert set(got) == set(want) and {"loss_cls", "loss_oicr_3", "loss_rpn_cls"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_train_gradients_match(note):
    grads_j, grads_t = note["grads_j"], note["grads_t"]
    trained = {k for k, v in grads_t.items() if v is not None}
    assert trained == set(grads_j) - {"embeddings"}
    assert {"backbone/conv2d_1a/kernel", "box_head/conv2d_7b/kernel",
            "rpn_head/conv/kernel"} <= trained
    for path in trained:
        want, g = grads_j[path], grads_t[path]
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(g - want).max() <= bound, (path, np.abs(g - want).max(), bound)


def test_predict_matches(note):
    (probs_j, bbox_j, props_j), (probs_t, bbox_t, props_t, feats_t) = note["raw_j"], note["raw_t"]
    assert tuple(feats_t.shape) == (2, 8, 12, 1088)  # not ceil(160/16) x ceil(224/16)
    for i in range(2):
        n = int(props_j.valid[i].sum())
        assert n == int(props_t.valid[i].sum()) == 16
        assert np.abs(props_t.boxes[i, :n].numpy() - props_j.boxes[i, :n]).max() < BOX_TOL
        assert np.abs(probs_t[i, :n].numpy() - probs_j[i, :n]).max() < PROB_TOL
        assert np.abs(bbox_t[i, :n].numpy() - bbox_j[i, :n]).max() < PROB_TOL
    dj, dt = note["dets_j"], note["dets_t"]
    for i in range(2):
        want = np.flatnonzero(dj.valid[i])
        got = np.flatnonzero(dt.valid[i].numpy())
        assert len(got) == len(want) > 0
        for k in want:
            assert any(int(dt.classes[i, m]) == int(dj.classes[i, k])
                       and abs(float(dt.scores[i, m]) - float(dj.scores[i, k])) < PROB_TOL
                       and np.abs(dt.boxes[i, m].numpy() - dj.boxes[i, k]).max() < BOX_TOL
                       for m in got), (i, k)


@pytest.mark.parametrize("hw", [(161, 223), (223, 161)])
def test_anchors_follow_the_map_at_an_odd_canvas(note, hw):
    """The block17 map of an odd canvas is what the unpadded stem leaves, not
    ceil(H/16) x ceil(W/16); the RPN's logits and anchors cover that map,
    in both packages."""
    tm = note["tm"]
    jm = JWSRCNN(mc=JModelConfig.from_cfg(note["jcfg"]))
    x = np.random.RandomState(5).uniform(0, 255, (1,) + hw + (3,)).astype(np.float32)
    want = jax.eval_shape(lambda p, v: jm.apply({"params": p}, v, method=JWSRCNN.features),
                          note["params"], jnp.asarray(x)).shape
    with torch.inference_mode():
        feats = tm.features(t(x))
        logits, _ = tm.rpn(feats)
        probs, _, props, _ = tm.predict_raw(t(x), t([hw]))
    h, w = feats.shape[1:3]
    assert tuple(feats.shape) == tuple(want) == (1, h, w, 1088)
    assert (h, w) != (-(-hw[0] // 16), -(-hw[1] // 16))
    assert logits.shape == (1, h * w * tm.mc.rpn.num_cell_anchors)
    assert int(props.valid.sum()) == 16 and bool(torch.isfinite(probs).all())
